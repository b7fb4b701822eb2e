"""Planar geometry (counterpart of `lav_tpu/core/geometry.py`): LAV's
coordinate conventions as batched elementwise tensor functions."""

from __future__ import annotations

import torch


def apply_rot2(x, y, cos, sin):
    """p' = p @ [[cos, sin], [-sin, cos]] for row vectors, elementwise."""
    return cos * x - sin * y, sin * x + cos * y


def transform_points(locs, oris):
    """Rotate (..., N, 2) point sets into frames given by `oris`; `oris`
    broadcasts against `locs[..., 0]` (a lower-rank `oris` is aligned to
    the leading axes)."""
    oris = torch.as_tensor(oris, dtype=locs.dtype, device=locs.device)
    cos, sin = torch.cos(oris), torch.sin(oris)
    if 0 < cos.ndim < locs.ndim - 1:
        shape = tuple(cos.shape) + (1,) * (locs.ndim - 1 - cos.ndim)
        cos, sin = cos.reshape(shape), sin.reshape(shape)
    xr, yr = apply_rot2(locs[..., 0], locs[..., 1], cos, sin)
    return torch.stack([xr, yr], dim=-1)


def move_lidar_points(lidar_xyz, dloc, ori0, ori1):
    """Re-register a sweep captured at pose (loc, ori1) into the frame of
    pose (loc0, ori0), with dloc = loc - loc0.  lidar_xyz (..., N, 3);
    dloc (..., 2); ori0, ori1 (...)."""
    c0, s0 = torch.cos(ori0), torch.sin(ori0)
    dx = dloc[..., 0] * c0 + dloc[..., 1] * s0
    dy = -dloc[..., 0] * s0 + dloc[..., 1] * c0
    d = torch.stack([dx, dy], dim=-1)
    ori = ori1 - ori0
    cos, sin = torch.cos(ori)[..., None], torch.sin(ori)[..., None]
    x, y = lidar_xyz[..., 0], lidar_xyz[..., 1]
    xr = cos * x - sin * y
    yr = sin * x + cos * y
    out = torch.stack([xr, yr], dim=-1) + d.unsqueeze(-2)
    return torch.cat([out, lidar_xyz[..., 2:3]], dim=-1)
