"""Static-shape PointPillars featurizer (counterpart of
`lav_tpu/ops/pillar.py`).

Points are padded to a fixed capacity with a validity mask; pillar id =
canvas_row * nx + canvas_col, with `ny*nx` the dump slot of invalid points;
a batch is folded into the segment space.  The per-pillar point mean
(decoration) sums [xyz, 1] in f32 with kernel `scatter_add` and gathers
sum / max(count, 1) back to the points.  Untouched pillars come out as
exactly 0 (LAV's zero canvas).  Both of lav_tpu's routes are here:

  use_pallas=False (production, the default): the canvas is kernel
    `scatter_max`, a zero-init max of the non-negative post-ReLU features
    in the compute dtype, over the B * ny * nx canvas rows; every invalid
    point gets the id B * ny * nx, outside the canvas, and is dropped, as
    lav_tpu's `mode="drop"` scatter drops it.  The decoration sums keep
    that id as an in-range dump row.  lav_tpu sorts the points first, a
    TPU tactic for its scatters; the sort changes only the order of the
    f32 decoration sums.
  use_pallas=True (`BENCH_PALLAS=1` in lav_tpu's bench): each item has its
    own dump slot in the decoration sums (pid + b * (ny*nx+1)), and the
    canvas is kernel `pillar_scatter_max` (NEG-init, NEG -> 0), the port
    of `pillar_scatter_max_pallas`, in f32 or bf16 (counted as
    `pillar_scatter_max_bf16`).  lav_tpu sends the masked points, which
    carry NEG, to the dump slots; here they get an id outside the canvas
    and are dropped, which gives the same canvas.  In bf16 NEG is -1e30
    rounded to bf16, and the canvas compares in bf16, as the Pallas kernel
    does.

Train mode (lav_tpu's train=True route, `ops/pillar.py:507-522`): the
decoration as in the production route and outside the gradient (lav_tpu's
stop_gradient), the point MLP's BatchNorm on the batch statistics of the
valid points, and the canvas as `CanvasMax`: forward kernel
`pillar_scatter_max` in f32 (lav_tpu's where(keep, feat, -1e30) ->
.at[pid].max over a -1e30 canvas -> where(> -1e30, ., 0), the invalid
points dropped here instead of masked), backward kernel
`pillar_scatter_max_bwd` (`pillar_scatter_max_bwd_plain` on the CPU),
which splits a cell's gradient evenly among the points tying for its max,
as JAX's scatter-max VJP does.

Kernel `scatter_add` (csrc/pillar_scatter.cu) ports lav_tpu's Pallas
`scatter_pallas` (ops/pillar_pallas2.py) with op="add"; kernels
`scatter_max` (its op="max") and `pillar_scatter_max` (lav_tpu's
`pillar_scatter_max_pallas`, ops/pillar_pallas.py) are one design in
csrc/pillar_scatter_max.cu.  Both maxima keep NaN as lav_tpu does: a NaN
payload lands and sticks, and `pillar_scatter_max`'s finalize turns it
into 0.
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


_K2_ENTRY = {torch.float32: native.ENTRIES["pillar_scatter_max_f32"],
             torch.bfloat16: native.ENTRIES["pillar_scatter_max_bf16"]}


def pillar_scatter_max(feat, pid, num_segments: int):
    """Kernel `pillar_scatter_max` (contract of `pillar_scatter_max_plain`),
    f32 or bf16 (C even).  CPU tensors take the plain version."""
    return _scatter("pillar_scatter_max", _K2_ENTRY.get(feat.dtype),
                    pillar_scatter_max_plain, feat, pid, num_segments,
                    canvas=True)


def pillar_scatter_max_bwd_plain(g, feat, pid, canvas):
    """Plain version of kernel `pillar_scatter_max_bwd`: g (S, C) the
    gradient of `pillar_scatter_max(feat, pid, S)`'s output `canvas` ->
    d_feat (N, C) f32: g[pid[p], c] * (1 / n) where feat[p, c] equals
    canvas[pid[p], c] and n points of the row tie there, else 0; dropped
    ids give 0."""
    S, C = canvas.shape
    ok = (pid >= 0) & (pid < S)
    s = torch.where(ok, pid.long(), torch.zeros_like(pid.long()))
    tie = ok[:, None] & (feat == canvas[s])
    n = canvas.new_zeros((S, C)).index_add_(0, s, tie.to(canvas.dtype))[s]
    share = g[s] * (1.0 / torch.where(tie, n, torch.ones_like(n)))
    return torch.where(tie, share, torch.zeros_like(share))


def pillar_scatter_max_bwd(g, feat, pid, canvas):
    """Kernel `pillar_scatter_max_bwd` (contract of
    `pillar_scatter_max_bwd_plain`), f32.  CPU tensors take the plain
    version."""
    dev = feat.get_device()
    if not (feat.is_cuda and feat.dtype is torch.float32
            and g.dtype is torch.float32 and canvas.dtype is torch.float32
            and pid.dtype is torch.int32 and feat.dim() == 2
            and pid.shape == feat.shape[:1] and g.shape == canvas.shape
            and canvas.dim() == 2 and canvas.shape[1] == feat.shape[1]
            and all(t.get_device() == dev for t in (g, pid, canvas))
            and all(t.is_contiguous() for t in (g, feat, pid, canvas))):
        if feat.device.type == "cpu":
            return pillar_scatter_max_bwd_plain(g, feat, pid, canvas)
        raise ValueError(
            f"pillar_scatter_max_bwd: g {g.dtype} {tuple(g.shape)}, feat "
            f"{feat.dtype} {tuple(feat.shape)}, pid {pid.dtype} "
            f"{tuple(pid.shape)}, canvas {canvas.dtype} "
            f"{tuple(canvas.shape)}: f32 (int32 pid), contiguous, on one "
            "CUDA device")
    N, C = feat.shape
    S = canvas.shape[0]
    out = torch.empty_like(feat)
    counts = torch.empty((S, C), dtype=torch.int32, device=feat.device)
    native.launch(native.ENTRIES["pillar_scatter_max_bwd_f32"], dev,
                  g.data_ptr(), feat.data_ptr(), pid.data_ptr(),
                  canvas.data_ptr(), out.data_ptr(), N, C, S,
                  counts.data_ptr())
    return out


class CanvasMax(torch.autograd.Function):
    """`pillar_scatter_max(feat, pid, S)` with its gradient to feat
    (`pillar_scatter_max_bwd`); pid gets none."""

    @staticmethod
    def forward(ctx, feat, pid, num_segments: int):
        canvas = pillar_scatter_max(feat, pid, num_segments)
        ctx.save_for_backward(feat, pid, canvas)
        return canvas

    @staticmethod
    def backward(ctx, g):
        feat, pid, canvas = ctx.saved_tensors
        return (pillar_scatter_max_bwd(g.contiguous(), feat, pid, canvas),
                None, None)


# csrc/pillar_scatter_max.cu's kTile, kHot, kGroupPoints and kAlign
CANVAS_TILE, CANVAS_HOT, CANVAS_GROUP_POINTS, CANVAS_ALIGN = 4096, 64, 32, 256


def canvas_scratch_bytes(n: int, C: int, num_segments: int,
                         elem: int) -> int:
    """Bytes of the scratch buffer the canvas max takes for n points of C
    channels of `elem` bytes into num_segments rows: the `Layout` of
    csrc/pillar_scatter_max.cu, array by array (each aligned to
    CANVAS_ALIGN): meta, counts, chunks done, tile sums, ranks, indices,
    hot rows, their first chunks, partial maxima."""
    def up(b):
        return -(-b // CANVAS_ALIGN) * CANVAS_ALIGN

    tiles = -(-(num_segments + 1) // CANVAS_TILE)
    max_hot = n // (CANVAS_HOT + 1) + 1
    max_chunks = n // CANVAS_GROUP_POINTS + max_hot
    return (up(16) + up(4 * tiles * CANVAS_TILE) + up(4 * max_hot)
            + up(4 * tiles) + 2 * up(4 * n) + 2 * up(4 * max_hot)
            + up(max_chunks * C * elem))


def _scatter(name, entry, plain, feat, pid, num_segments: int,
             canvas: bool):
    """Launch `entry` (kernel `name`) on (feat, pid); CPU tensors take
    `plain`.  A canvas max writes every row of an uninitialised output and
    takes a scratch buffer (`canvas_scratch_bytes`); the add sums into a
    zeroed one.  The checks the scatters share (int32 pid (N,) beside feat
    (N, C) on its device, both contiguous, bf16 rows in 4-byte channel
    pairs) are one test on the fast path; `_refuse` says what is wrong."""
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
    if not canvas:
        out = feat.new_zeros((num_segments, C))
        native.launch(entry, dev, feat.data_ptr(), pid.data_ptr(),
                      out.data_ptr(), N, C, num_segments)
        return out
    out = feat.new_empty((num_segments, C))
    scratch = torch.empty(canvas_scratch_bytes(N, C, num_segments,
                                               feat.element_size()),
                          dtype=torch.uint8, device=feat.device)
    native.launch(entry, dev, feat.data_ptr(), pid.data_ptr(),
                  out.data_ptr(), N, C, num_segments, scratch.data_ptr(),
                  scratch.numel())
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
                    scatter_max_plain, feat, pid, num_segments, canvas=True)


def scatter_add(feat, pid, num_segments: int):
    """Kernel `scatter_add` (contract of `scatter_add_plain`), the
    decoration sums.  CPU tensors take the plain version."""
    return _scatter("scatter_add", _K3_ENTRY.get(("add", feat.dtype)),
                    scatter_add_plain, feat, pid, num_segments, canvas=False)


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
        if self.training:
            canvas = CanvasMax.apply(feat.contiguous(), canvas_pid, B * G)
        else:
            kernel = pillar_scatter_max if use_pallas else scatter_max
            canvas = kernel(feat.contiguous(), canvas_pid, B * G)
        return canvas.reshape(B, ny, nx, C)
