"""Static-shape PointPillars featurizer in plain PyTorch: a frozen copy of
the port's plain forms.

Points are padded to a fixed capacity with a validity mask; pillar id =
canvas_row * nx + canvas_col, with `ny*nx` the dump slot of invalid points;
a batch is folded into the segment space.  The per-pillar point mean
(decoration) sums [xyz, 1] in f32 and gathers sum / max(count, 1) back to
the points.  Untouched pillars come out as exactly 0.  The canvas is a
max over the points: from zero (`scatter_max_plain`, the production eval
route) or from NEG, NEG -> 0 (`pillar_scatter_max_plain`, train mode and
the use_pallas route).  Autograd of `scatter_reduce(amax)` splits a
cell's gradient evenly among the points tying for its max, the zero the
canvas starts from counting as one more tie on the zero-init route.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lavbench.ref.nn import layers as L

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
    sum in f32; mean = sum / max(count, 1)."""
    v = torch.where(keep[:, None], values, torch.zeros_like(values))
    packed = torch.cat([v.float(), keep.float()[:, None]], dim=-1)
    acc = scatter_add_plain(packed, pid.to(torch.int32).contiguous(),
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
    bf16, pid (N,) -> (num_segments, C): a canvas filled with NEG in
    feat's dtype, max over the points (a NaN lands and sticks), values not
    above that NEG (NaN included) -> 0; ids outside the range are
    dropped."""
    C = feat.shape[-1]
    canvas = torch.full((num_segments, C), NEG, dtype=feat.dtype,
                        device=feat.device)
    neg = torch.tensor(NEG, dtype=feat.dtype, device=feat.device)
    ok = (pid >= 0) & (pid < num_segments)
    canvas.scatter_reduce_(0, pid.long()[ok][:, None].expand(-1, C),
                           feat[ok], "amax", include_self=True)
    return torch.where(canvas > neg, canvas, torch.zeros_like(canvas))


def scatter_max_plain(feat, pid, num_segments: int):
    """Plain version of kernel `scatter_max`: feat (N, C) f32 or bf16,
    pid (N,) -> (num_segments, C): a zero canvas raised to each point's
    features (max(0, max over points); a NaN lands and sticks, as in
    lav_tpu's drop scatter); ids outside the range are dropped."""
    C = feat.shape[-1]
    canvas = feat.new_zeros((num_segments, C))
    ok = (pid >= 0) & (pid < num_segments)
    canvas.scatter_reduce_(0, pid.long()[ok][:, None].expand(-1, C),
                           feat[ok], "amax", include_self=True)
    return canvas


def scatter_add_plain(feat, pid, num_segments: int):
    """Plain version of kernel `scatter_add`: feat (N, C) f32, pid (N,)
    -> (num_segments, C) f32 per-segment sums, each added in point order
    from 0 (index_add_ on the CPU); ids outside the range are dropped."""
    ok = (pid >= 0) & (pid < num_segments)
    acc = feat.new_zeros((num_segments, feat.shape[-1]))
    return acc.index_add_(0, pid.long()[ok], feat[ok])


class PointPillar(nn.Module):
    """Point MLP (linear -> BN -> ReLU per layer) + canvas max.

    forward(points (B, P, D), valid (B, P), use_pallas=False) -> canvas
    (B, ny, nx, C) in points' dtype (see the module note for the two
    eval routes and the train route)."""

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
        self.eval()   # inference unless a caller asks for train mode

    def forward(self, points, valid, use_pallas: bool = False):
        nx, ny = self.nx, self.ny
        G = ny * nx
        B, P, D = points.shape
        pid, keep, ix, iy = compute_pillar_ids(points, valid, nx=nx, ny=ny,
                                               **self.geo)
        offs = torch.arange(B, dtype=pid.dtype, device=pid.device)[:, None]
        # the canvas' ids: B * G (outside the canvas) for invalid points
        canvas_pid = torch.where(keep, pid + offs * G,
                                 torch.full_like(pid, B * G)).reshape(-1)
        if use_pallas and not self.training:  # per-item dump slots
            S = B * (G + 1)
            pid_flat = (pid + offs * (G + 1)).reshape(-1).contiguous()
        else:              # B * G is the sums' dump row
            S = B * G + 1
            pid_flat = canvas_pid
        keep = keep.reshape(-1)
        with torch.no_grad():
            feat = decorate_points(
                points.reshape(-1, D), pid_flat, keep, ix.reshape(-1),
                iy.reshape(-1), min_x=self.geo["min_x"],
                min_y=self.geo["min_y"],
                pixels_per_meter=self.geo["pixels_per_meter"],
                num_segments=S)
        for i in range(self.num_layers):   # train-mode BN: valid points
            feat = getattr(self, f"linear_{i}")(feat)
            feat = F.relu(getattr(self, f"bn_{i}")(feat, mask=keep))
        C = feat.shape[-1]
        neg_init = self.training or use_pallas
        canvas = (pillar_scatter_max_plain if neg_init else
                  scatter_max_plain)(feat, canvas_pid, B * G)
        return canvas.reshape(B, ny, nx, C)
