"""Point painting: project lidar points into the cameras' semantic maps
(counterpart of `lav_tpu/ops/painting.py`), batched over egos.

Conventions (CARLA/UE4, left-handed, x forward, y right, z up): lidar
mounted unrotated; world -> camera is R_z(yaw)^T (p - cam_xyz); the image
axes are (y_c, -z_c, x_c) with a pinhole K.  Cameras later in the list
override earlier ones where both see a point.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch


class CameraRig(NamedTuple):
    """Static projection constants for one camera (numpy, built on host)."""
    rot: np.ndarray       # (3, 3) world -> camera rotation R_z(yaw)^T
    trans: np.ndarray     # (3,) lidar position minus camera position
    K: np.ndarray         # (3, 3) intrinsics
    width: int
    height: int

    @staticmethod
    def build(cam_yaw_deg: float, lidar_xyz=(0.0, 0.0, 2.5),
              cam_xyz=(1.4, 0.0, 2.5), rgb_h: int = 320, rgb_w: int = 320,
              fov: float = 60.0) -> "CameraRig":
        focal = rgb_w / (2.0 * math.tan(fov * math.pi / 360.0))
        K = np.eye(3)
        K[0, 0] = K[1, 1] = focal
        K[0, 2] = rgb_w / 2.0
        K[1, 2] = rgb_h / 2.0
        yaw = math.radians(cam_yaw_deg)
        c, s = math.cos(yaw), math.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        return CameraRig(
            rot=R.T,
            trans=(np.asarray(lidar_xyz, np.float64)
                   - np.asarray(cam_xyz, np.float64)),
            K=K, width=rgb_w, height=rgb_h)


def project_to_camera(rig: CameraRig, lidar_xyz):
    """lidar_xyz (..., N, 3) -> (u, v, z) int32 pixel coordinates and
    depth, truncated toward zero as LAV's `astype(int)`.  Values are
    clamped in float before the cast (where a huge float has no defined
    int32); the clamp keeps every comparison the painting makes."""
    dt, dev = lidar_xyz.dtype, lidar_xyz.device
    p = lidar_xyz + torch.as_tensor(rig.trans, dtype=dt, device=dev)
    cam = p @ torch.as_tensor(rig.rot.T, dtype=dt, device=dev)
    img_axes = torch.stack([cam[..., 1], -cam[..., 2], cam[..., 0]], dim=-1)
    proj = img_axes @ torch.as_tensor(rig.K, dtype=dt, device=dev).T
    z = proj[..., 2]
    u = proj[..., 0] / (1e-5 + z)
    v = proj[..., 1] / (1e-5 + z)
    big = float(max(rig.width, rig.height) + 2)

    def to_int(t):
        return torch.trunc(torch.nan_to_num(t).clamp(-big, big)).to(
            torch.int32)

    return to_int(u), to_int(v), to_int(z)


def point_painting(lidar_xyz, sems, rigs: Sequence[CameraRig], valid=None):
    """lidar_xyz (E, N, 3); sems (E, num_cams, H, W, C) probabilities;
    valid (E, N) -> painted (E, N, C).  A point no camera sees gets zeros
    (it indexes an appended zero row), as does one whose index lands past
    the ego's maps (a rig larger than the maps); one that lands in a later
    camera's map takes that pixel, as lav_tpu's flat gather does."""
    E, N, _ = lidar_xyz.shape
    _, num_cams, H, W, C = sems.shape
    per_ego = num_cams * H * W
    sems_flat = torch.cat([sems.reshape(E * per_ego, C),
                           sems.new_zeros((1, C))], dim=0)
    zero_row = E * per_ego
    base = (torch.arange(E, device=sems.device) * per_ego)[:, None]
    idx = torch.full((E, N), zero_row, dtype=torch.long, device=sems.device)
    for i, rig in enumerate(rigs):
        u, v, z = project_to_camera(rig, lidar_xyz)
        ok = (z >= 0) & (u >= 0) & (u < rig.width) & (v >= 0) & (
            v < rig.height)
        if valid is not None:
            ok = ok & valid
        uc = u.clamp(0, rig.width - 1).long()
        vc = v.clamp(0, rig.height - 1).long()
        local = i * H * W + vc * W + uc
        if rig.height > H or rig.width > W:
            # past the ego's last map lav_tpu's take(mode="fill") gives 0
            local = torch.where(local < per_ego, local, zero_row - base)
        idx = torch.where(ok, base + local, idx)
    return sems_flat[idx]
