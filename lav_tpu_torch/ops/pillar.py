"""Static-shape PointPillars featurizer, inference path (counterpart of
`lav_tpu/ops/pillar.py` under `use_pallas=True`).

Points are padded to a fixed capacity with a validity mask; pillar id =
canvas_row * nx + canvas_col, with `ny*nx` the dump slot of invalid points;
a batch is folded into the segment space (pid + b * (ny*nx + 1)).  The
per-pillar point mean (decoration) is one `index_add_` + gather; the
per-pillar max over the MLP features is kernel `pillar_scatter_max`
(csrc/pillar_scatter_max.cu), the port of lav_tpu's Pallas
`pillar_scatter_max_pallas`.  Masked points carry NEG so they never win
the max, and untouched pillars come out as exactly 0 (LAV's zero canvas).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.utils import native

NEG = -1e30


def compute_pillar_ids(points, valid, *, min_x: float, max_x: float,
                       min_y: float, max_y: float, pixels_per_meter: float,
                       nx: int, ny: int):
    """points (..., P, D>=2) -> (pid, keep, ix, iy), each (..., P).

    pid int32 in [0, ny*nx] (ny*nx = dump slot); keep = in range AND valid;
    ix, iy the clamped integer grid coords.  The forward (x) axis runs up
    the canvas rows, the lateral (y) axis along the columns.  Coordinates
    are clamped in float before the integer cast (a huge float has no
    defined int32 value in torch)."""
    x, y = points[..., 0], points[..., 1]
    keep = valid & (x >= min_x) & (x < max_x) & (y >= min_y) & (y < max_y)
    ix = torch.clamp(torch.floor((x - min_x) * pixels_per_meter), 0, ny - 1)
    iy = torch.clamp(torch.floor((y - min_y) * pixels_per_meter), 0, nx - 1)
    ix = torch.nan_to_num(ix).to(torch.int32)
    iy = torch.nan_to_num(iy).to(torch.int32)
    row = ny - 1 - ix
    pid = torch.where(keep, row * nx + iy, torch.full_like(row, ny * nx))
    return pid, keep, ix, iy


def segment_mean_gather(values, pid, keep, num_segments: int):
    """Per-segment mean of values (N, D) over pid (N,), gathered back to
    the points -> (N, D).  Invalid points contribute nothing."""
    v = torch.where(keep[:, None], values, torch.zeros_like(values))
    packed = torch.cat([v, keep.to(values.dtype)[:, None]], dim=-1)
    acc = values.new_zeros((num_segments, packed.shape[-1]))
    acc.index_add_(0, pid.long(), packed)
    D = values.shape[-1]
    means = acc[:, :D] / torch.clamp(acc[:, D:D + 1], min=1.0)
    return means[pid.long()]


def decorate_points(points, pid, keep, ix, iy, *, min_x: float, min_y: float,
                    pixels_per_meter: float, num_segments: int):
    """Append LAV's 5 decoration channels to points (N, D): xyz offset from
    the pillar's point mean (3) and xy offset from the cell origin (2).
    LAV's quirk is kept on purpose: x_center reads the column index iy and
    y_center the row index ix (the released models were trained so)."""
    xyz = points[..., :3]
    cluster = xyz - segment_mean_gather(xyz, pid, keep, num_segments)
    x_center = iy.to(points.dtype) / pixels_per_meter + min_x
    y_center = ix.to(points.dtype) / pixels_per_meter + min_y
    xp = points[..., 0] - x_center
    yp = points[..., 1] - y_center
    return torch.cat([points, cluster, xp[..., None], yp[..., None]], dim=-1)


def pillar_scatter_max_plain(feat, pid, num_segments: int):
    """Plain version of kernel `pillar_scatter_max`: feat (N, C) f32, pid
    (N,) in [0, num_segments) -> (num_segments, C): NEG-filled canvas,
    max over the points, NEG -> 0."""
    C = feat.shape[-1]
    canvas = torch.full((num_segments, C), NEG, dtype=feat.dtype,
                        device=feat.device)
    canvas.scatter_reduce_(0, pid.long()[:, None].expand(-1, C), feat,
                           "amax", include_self=True)
    return torch.where(canvas > NEG, canvas, torch.zeros_like(canvas))


def pillar_scatter_max(feat, pid, num_segments: int):
    """Kernel `pillar_scatter_max` (contract of `pillar_scatter_max_plain`).
    CPU tensors take the plain version."""
    if feat.device.type == "cpu":
        return pillar_scatter_max_plain(feat, pid, num_segments)
    if feat.device.type != "cuda" or pid.device != feat.device:
        raise ValueError(f"pillar_scatter_max: feat on {feat.device}, pid on "
                         f"{pid.device}; both must be on one CUDA device")
    if feat.dtype != torch.float32 or pid.dtype != torch.int32:
        raise TypeError(f"pillar_scatter_max: feat {feat.dtype} (f32), pid "
                        f"{pid.dtype} (int32)")
    if feat.ndim != 2 or pid.shape != feat.shape[:1]:
        raise ValueError(f"pillar_scatter_max: feat {tuple(feat.shape)}, pid "
                         f"{tuple(pid.shape)}")
    if not (feat.is_contiguous() and pid.is_contiguous()):
        raise ValueError("pillar_scatter_max: inputs must be contiguous")
    N, C = feat.shape
    out = torch.empty((num_segments, C), dtype=feat.dtype, device=feat.device)
    fn = _lib().pillar_scatter_max_f32
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        err = fn(feat.data_ptr(), pid.data_ptr(), out.data_ptr(), N, C,
                 num_segments, stream)
    native.check(err, "pillar_scatter_max")
    native.LAUNCHES["pillar_scatter_max"] += 1
    return out


def _lib():
    lib = native.load("pillar_scatter_max")
    fn = lib.pillar_scatter_max_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class PointPillar(nn.Module):
    """Point MLP (linear -> eval BN -> ReLU per layer) + canvas max.

    forward(points (B, P, D), valid (B, P)) -> canvas (B, ny, nx, C)."""

    def __init__(self, num_input: int, num_features: Sequence[int], *,
                 min_x: float, max_x: float, min_y: float, max_y: float,
                 pixels_per_meter: float, gen=None):
        super().__init__()
        cin = num_input
        self.num_layers = len(num_features)
        for i, c in enumerate(num_features):
            setattr(self, f"linear_{i}", L.Linear(cin, c, gen=gen))
            setattr(self, f"bn_{i}", L.BatchNorm(c, dim=-1))
            cin = c
        self.geo = dict(min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
                        pixels_per_meter=pixels_per_meter)
        self.nx = int((max_x - min_x) * pixels_per_meter)
        self.ny = int((max_y - min_y) * pixels_per_meter)

    def forward(self, points, valid):
        nx, ny = self.nx, self.ny
        S = ny * nx + 1
        B, P, D = points.shape
        pid, keep, ix, iy = compute_pillar_ids(points, valid, nx=nx, ny=ny,
                                               **self.geo)
        offs = torch.arange(B, dtype=pid.dtype, device=pid.device)[:, None]
        pid_flat = (pid + offs * S).reshape(-1)
        feat = decorate_points(
            points.reshape(-1, D), pid_flat, keep.reshape(-1),
            ix.reshape(-1), iy.reshape(-1), min_x=self.geo["min_x"],
            min_y=self.geo["min_y"],
            pixels_per_meter=self.geo["pixels_per_meter"],
            num_segments=B * S)
        for i in range(self.num_layers):
            feat = getattr(self, f"linear_{i}")(feat)
            feat = F.relu(getattr(self, f"bn_{i}")(feat))
        feat = torch.where(keep.reshape(-1, 1), feat,
                           torch.full_like(feat, NEG))
        C = feat.shape[-1]
        canvas = pillar_scatter_max(feat.contiguous(), pid_flat.contiguous(),
                                    B * S)
        return canvas.reshape(B, S, C)[:, :ny * nx].reshape(B, ny, nx, C)
