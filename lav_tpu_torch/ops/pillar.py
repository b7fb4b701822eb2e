"""Static-shape PointPillars featurizer, inference path (counterpart of
`lav_tpu/ops/pillar.py`, `train=False`).

Points are padded to a fixed capacity with a validity mask; pillar id =
canvas_row * nx + canvas_col, with `ny*nx` the dump slot of invalid points;
a batch is folded into the segment space.  The per-pillar point mean
(decoration) sums [xyz, 1] in f32 with kernel `scatter_add` and gathers
sum / max(count, 1) back to the points.  Untouched pillars come out as
exactly 0 (LAV's zero canvas).  Both of lav_tpu's routes are here:

  use_pallas=False (production, the default): the canvas is kernel
    `scatter_max`, a zero-init max of the non-negative post-ReLU features
    in the compute dtype; every invalid point goes to one dump row past
    the B * ny * nx canvas rows, which is sliced off.  lav_tpu sorts the
    points first, a TPU tactic for its scatters; the sort changes only the
    order of the f32 decoration sums.
  use_pallas=True (`BENCH_PALLAS=1` in lav_tpu's bench): each item has its
    own dump slot (pid + b * (ny*nx+1)); masked points carry NEG and the
    canvas is kernel `pillar_scatter_max` (NEG-init, NEG -> 0), the port
    of `pillar_scatter_max_pallas`, in f32 or bf16 (counted as
    `pillar_scatter_max_bf16`).  In bf16 NEG is -1e30 rounded to bf16, and
    the canvas compares in bf16, as the Pallas kernel does.

Kernels `scatter_max` and `scatter_add` (csrc/pillar_scatter.cu) port
lav_tpu's Pallas `scatter_pallas` (ops/pillar_pallas2.py), and
`pillar_scatter_max` (csrc/pillar_scatter_max.cu) its
`pillar_scatter_max_pallas` (ops/pillar_pallas.py).
"""

from __future__ import annotations

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
    defined int32 value in torch); the cell index is computed in the
    points' dtype, as lav_tpu does, and clamped in f32, which holds every
    index (bf16 would round 319 to 320)."""
    x, y = points[..., 0], points[..., 1]
    keep = valid & (x >= min_x) & (x < max_x) & (y >= min_y) & (y < max_y)
    ix = torch.clamp(torch.floor((x - min_x) * pixels_per_meter).float(), 0,
                     ny - 1)
    iy = torch.clamp(torch.floor((y - min_y) * pixels_per_meter).float(), 0,
                     nx - 1)
    ix = torch.nan_to_num(ix).to(torch.int32)
    iy = torch.nan_to_num(iy).to(torch.int32)
    row = ny - 1 - ix
    pid = torch.where(keep, row * nx + iy, torch.full_like(row, ny * nx))
    return pid, keep, ix, iy


def segment_mean_gather(values, pid, keep, num_segments: int):
    """Per-segment mean of values (N, D) over pid (N,), gathered back to
    the points -> (N, D) in values' dtype.  [values, 1] of the valid points
    sum in f32 (kernel `scatter_add`); mean = sum / max(count, 1)."""
    v = torch.where(keep[:, None], values, torch.zeros_like(values))
    packed = torch.cat([v.float(), keep.float()[:, None]], dim=-1)
    acc = scatter_add(packed, pid.to(torch.int32).contiguous(),
                      num_segments)
    D = values.shape[-1]
    means = acc[:, :D] / torch.clamp(acc[:, D:D + 1], min=1.0)
    return means[pid.long()].to(values.dtype)


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
    """Plain version of kernel `pillar_scatter_max`: feat (N, C) f32 or
    bf16, pid (N,) in [0, num_segments) -> (num_segments, C): a canvas
    filled with NEG in feat's dtype, max over the points, values not above
    that NEG -> 0."""
    C = feat.shape[-1]
    canvas = torch.full((num_segments, C), NEG, dtype=feat.dtype,
                        device=feat.device)
    neg = torch.tensor(NEG, dtype=feat.dtype, device=feat.device)
    canvas.scatter_reduce_(0, pid.long()[:, None].expand(-1, C), feat,
                           "amax", include_self=True)
    return torch.where(canvas > neg, canvas, torch.zeros_like(canvas))


_K2_ENTRY = {torch.float32: native.ENTRIES["pillar_scatter_max_f32"],
             torch.bfloat16: native.ENTRIES["pillar_scatter_max_bf16"]}


def pillar_scatter_max(feat, pid, num_segments: int):
    """Kernel `pillar_scatter_max` (contract of `pillar_scatter_max_plain`),
    f32 or bf16 (C even).  CPU tensors take the plain version."""
    return _scatter("pillar_scatter_max", _K2_ENTRY.get(feat.dtype),
                    pillar_scatter_max_plain, feat.new_empty, feat, pid,
                    num_segments)


def _scatter(name, entry, plain, alloc, feat, pid, num_segments: int):
    """Launch `entry` (kernel `name`) on (feat, pid) into an output from
    `alloc`; CPU tensors take `plain`.  The checks the three scatters share
    (int32 pid (N,) beside feat (N, C) on its device, both contiguous, bf16
    rows in 4-byte channel pairs) are one test on the fast path; `_refuse`
    says what is wrong."""
    dev = feat.get_device()
    if not (feat.is_cuda and entry is not None and pid.dtype is torch.int32
            and feat.dim() == 2 and pid.dim() == 1
            and pid.shape[0] == feat.shape[0] and pid.get_device() == dev
            and feat.is_contiguous() and pid.is_contiguous()
            and (feat.dtype is not torch.bfloat16
                 or (feat.shape[1] % 2 == 0 and feat.data_ptr() % 4 == 0))):
        if feat.device.type == "cpu":
            return plain(feat, pid, num_segments)
        _refuse(name, entry, feat, pid)
    N, C = feat.shape
    out = alloc((num_segments, C))
    native.launch(entry, dev, feat.data_ptr(), pid.data_ptr(),
                  out.data_ptr(), N, C, num_segments)
    return out


def _refuse(name, entry, feat, pid):
    """Raise with what makes (feat, pid) unfit for kernel `name`."""
    if feat.device.type != "cuda" or pid.device != feat.device:
        raise ValueError(f"{name}: feat on {feat.device}, pid on "
                         f"{pid.device}; both must be on one CUDA device")
    if entry is None or pid.dtype != torch.int32:
        raise TypeError(f"{name}: feat {feat.dtype}, pid {pid.dtype} (int32)")
    if feat.ndim != 2 or pid.shape != feat.shape[:1]:
        raise ValueError(f"{name}: feat {tuple(feat.shape)}, pid "
                         f"{tuple(pid.shape)}")
    if not (feat.is_contiguous() and pid.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    raise ValueError(f"{name}: bf16 rows must be channel pairs")


def scatter_max_plain(feat, pid, num_segments: int):
    """Plain version of kernel `scatter_max`: feat (N, C) f32 or bf16,
    pid (N,) -> (num_segments, C): a zero canvas raised to each point's
    features (max(0, max over points)); ids outside the range are
    dropped."""
    C = feat.shape[-1]
    canvas = feat.new_zeros((num_segments, C))
    ok = (pid >= 0) & (pid < num_segments)
    canvas.scatter_reduce_(0, pid.long()[ok][:, None].expand(-1, C),
                           feat[ok], "amax", include_self=True)
    return canvas


def scatter_add_plain(feat, pid, num_segments: int):
    """Plain version of kernel `scatter_add`: feat (N, C) f32, pid (N,)
    -> (num_segments, C) f32 per-segment sums; ids outside the range are
    dropped."""
    ok = (pid >= 0) & (pid < num_segments)
    acc = feat.new_zeros((num_segments, feat.shape[-1]))
    return acc.index_add_(0, pid.long()[ok], feat[ok])


_K3_ENTRY = {("max", torch.bfloat16): native.ENTRIES["scatter_max_bf16"],
             ("max", torch.float32): native.ENTRIES["scatter_max_f32"],
             ("add", torch.float32): native.ENTRIES["scatter_add_f32"]}


def scatter_max(feat, pid, num_segments: int):
    """Kernel `scatter_max` (contract of `scatter_max_plain`), the canvas
    of the production route.  CPU tensors take the plain version."""
    return _scatter("scatter_max", _K3_ENTRY.get(("max", feat.dtype)),
                    scatter_max_plain, feat.new_zeros, feat, pid,
                    num_segments)


def scatter_add(feat, pid, num_segments: int):
    """Kernel `scatter_add` (contract of `scatter_add_plain`), the
    decoration sums.  CPU tensors take the plain version."""
    return _scatter("scatter_add", _K3_ENTRY.get(("add", feat.dtype)),
                    scatter_add_plain, feat.new_zeros, feat, pid,
                    num_segments)


class PointPillar(nn.Module):
    """Point MLP (linear -> eval BN -> ReLU per layer) + canvas max.

    forward(points (B, P, D), valid (B, P), use_pallas=False) -> canvas
    (B, ny, nx, C) in points' dtype (see the module note for the two
    routes)."""

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

    def forward(self, points, valid, use_pallas: bool = False):
        nx, ny = self.nx, self.ny
        G = ny * nx
        B, P, D = points.shape
        pid, keep, ix, iy = compute_pillar_ids(points, valid, nx=nx, ny=ny,
                                               **self.geo)
        offs = torch.arange(B, dtype=pid.dtype, device=pid.device)[:, None]
        if use_pallas:
            S = B * (G + 1)
            pid_flat = (pid + offs * (G + 1)).reshape(-1)
        else:
            S = B * G + 1
            pid_flat = torch.where(keep, pid + offs * G,
                                   torch.full_like(pid, B * G)).reshape(-1)
        pid_flat = pid_flat.contiguous()
        keep = keep.reshape(-1)
        feat = decorate_points(
            points.reshape(-1, D), pid_flat, keep, ix.reshape(-1),
            iy.reshape(-1), min_x=self.geo["min_x"], min_y=self.geo["min_y"],
            pixels_per_meter=self.geo["pixels_per_meter"], num_segments=S)
        for i in range(self.num_layers):
            feat = getattr(self, f"linear_{i}")(feat)
            feat = F.relu(getattr(self, f"bn_{i}")(feat))
        C = feat.shape[-1]
        if not use_pallas:
            canvas = scatter_max(feat.contiguous(), pid_flat, S)
            return canvas[:B * G].reshape(B, ny, nx, C)
        feat = torch.where(keep[:, None], feat, torch.full_like(feat, NEG))
        canvas = pillar_scatter_max(feat.contiguous(), pid_flat, S)
        return canvas.reshape(B, G + 1, C)[:, :G].reshape(B, ny, nx, C)
