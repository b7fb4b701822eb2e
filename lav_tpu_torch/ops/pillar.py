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
    f32 decoration sums.  Its gradient (`ScatterMax`) is lav_tpu's, the
    VJP of `zeros.at[pid].max(feat, mode="drop")`: kernel
    `scatter_max_bwd` on the card, `scatter_max_bwd_plain` on the CPU,
    which split a cell's gradient among its tied points as the train
    route does and count the zero the canvas starts from as one more tie
    where the cell's max is 0.
  use_pallas=True (`BENCH_PALLAS=1` in lav_tpu's bench): each item has its
    own dump slot in the decoration sums (pid + b * (ny*nx+1)), and the
    canvas is kernel `pillar_scatter_max` (NEG-init, NEG -> 0), the port
    of `pillar_scatter_max_pallas`, in f32 or bf16 (counted as
    `pillar_scatter_max_bf16`).  lav_tpu sends the masked points, which
    carry NEG, to the dump slots; here they get an id outside the canvas
    and are dropped, which gives the same canvas.  In bf16 NEG is -1e30
    rounded to bf16, and the canvas compares in bf16, as the Pallas kernel
    does.  lav_tpu cannot differentiate this route, and neither can the
    port: `PallasEvalMax`'s backward raises.

Train mode (lav_tpu's train=True route, `ops/pillar.py:507-522`): the
decoration as in the production route and outside the gradient (lav_tpu's
stop_gradient), the point MLP's BatchNorm on the batch statistics of the
valid points, and the canvas as `CanvasMax`: forward kernel
`pillar_scatter_max` in the points' dtype, f32 or bf16 (lav_tpu's
where(keep, feat, -1e30) -> .at[pid].max over a -1e30 canvas ->
where(> -1e30, ., 0), the invalid points dropped here instead of masked),
backward kernel `pillar_scatter_max_bwd` (`pillar_scatter_max_bwd_plain`
on the CPU), which splits a cell's gradient evenly among the points tying
for its max, as JAX's scatter-max VJP does, with JAX's tie count: a sum
of ones in the feature dtype, which stops at 256 in bf16.

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


def pillar_scatter_max(feat, pid, num_segments: int, keep_sort: bool = False):
    """Kernel `pillar_scatter_max` (contract of `pillar_scatter_max_plain`),
    f32 or bf16 (C even).  CPU tensors take the plain version.  With
    `keep_sort`, -> (canvas, sort): the kernel's scratch, which holds its
    counting sort of the points by row (`read_canvas_sort`), for
    `pillar_scatter_max_bwd`; on the CPU `canvas_sort_plain` builds it."""
    if native.EXPORTING and not keep_sort:
        return _OPS["pillar_scatter_max"](feat, pid, num_segments)
    return _pillar_scatter_max(feat, pid, num_segments, keep_sort)


def _pillar_scatter_max(feat, pid, num_segments: int, keep_sort=False):
    return _scatter("pillar_scatter_max", _K2_ENTRY.get(feat.dtype),
                    pillar_scatter_max_plain, feat, pid, num_segments,
                    canvas=True, keep_sort=keep_sort)


def tie_count(n, dtype):
    """A cell's tie count n (an integer tensor) as JAX's scatter-max VJP
    counts it: a scatter_add of ones in `dtype`, which stops where adding
    1 rounds back (256 in bf16, 2^24 in f32) -> n in `dtype`."""
    return torch.clamp(n, max=int(2 / torch.finfo(dtype).eps)).to(dtype)


def _share(g, n, tie, zero_init: bool = False):
    """g * (1 / n) where `tie`, else 0; n the tie counts (int64), the
    reciprocal and the product in g's dtype (each an f32 value rounded once
    in bf16).  With `zero_init` the product is taken everywhere, with a
    factor of 0 where no tie, as JAX's VJP of `zeros.at[].max` takes it:
    a NaN or inf in g gives NaN to the points of its row that do not tie."""
    n = torch.where(tie, n, torch.ones_like(n))
    rcp = (1.0 / tie_count(n, g.dtype).float()).to(g.dtype)
    if zero_init:
        return g * torch.where(tie, rcp, torch.zeros_like(rcp))
    return torch.where(tie, g * rcp, torch.zeros_like(g))


def _ties(feat, canvas, rows, zero_init: bool, ok=True):
    """(tie, n) of points `feat` in rows `rows` (int64, in range), those
    of `ok` only: whether each equals its row's max, and how many points of
    the row do, plus one where that max is 0 with `zero_init` (the zero
    operand ties there)."""
    tie = (feat == canvas[rows]) & ok
    n = torch.zeros(canvas.shape, dtype=torch.int64, device=canvas.device)
    n = n.index_add_(0, rows, tie.long())
    if zero_init:
        n = n + (canvas == 0).long()
    return tie, n[rows]


def pillar_scatter_max_bwd_plain(g, feat, pid, canvas, zero_init=False):
    """Plain version of kernel `pillar_scatter_max_bwd`: g (S, C) the
    gradient of `pillar_scatter_max(feat, pid, S)`'s output `canvas`, all
    f32 or all bf16 -> d_feat (N, C) in that dtype: g[pid[p], c] * (1 / n)
    where feat[p, c] equals canvas[pid[p], c] and n points of the row tie
    there (`tie_count`: at most 256 in bf16), else 0; dropped ids give
    0.  With `zero_init`, `scatter_max_bwd_plain`."""
    S, C = canvas.shape
    ok = (pid >= 0) & (pid < S)
    s = torch.where(ok, pid.long(), torch.zeros_like(pid.long()))
    tie, n = _ties(feat, canvas, s, zero_init, ok[:, None])
    out = _share(g[s], n, tie, zero_init)
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def scatter_max_bwd_plain(g, feat, pid, canvas):
    """Plain version of kernel `scatter_max_bwd`: the gradient of the
    zero-init canvas max `scatter_max(feat, pid, S)` as `jax.vjp` of
    lav_tpu's `jnp.zeros((S, C)).at[pid].max(feat, mode="drop")` gives it.
    `pillar_scatter_max_bwd_plain`'s split, where a row's max of 0 counts
    the zero it started from as one more tie (n = ties + 1 there, through
    `tie_count`: at most 256 in bf16), and g times 0 at the points that do
    not tie (NaN where g is NaN or inf); dropped ids give 0."""
    return pillar_scatter_max_bwd_plain(g, feat, pid, canvas, zero_init=True)


def pillar_scatter_max_bwd_sorted_plain(g, feat, canvas, offsets, idx,
                                        zero_init=False):
    """Plain version of kernel `pillar_scatter_max_bwd` (with `zero_init`,
    `scatter_max_bwd`) on the forward's sort (`read_canvas_sort`: row r's
    points are idx[offsets[r]:offsets[r + 1]]): the ties counted row by
    row over the sorted points; the same function as the plain version,
    exactly."""
    S, C = canvas.shape
    rows = torch.repeat_interleave(
        torch.arange(S, device=canvas.device), offsets.diff())
    tie, n = _ties(feat[idx], canvas, rows, zero_init)
    out = feat.new_zeros(feat.shape)
    out[idx] = _share(g[rows], n, tie, zero_init)
    return out


_BWD_ENTRY = {
    (False, torch.float32): native.ENTRIES["pillar_scatter_max_bwd_f32"],
    (False, torch.bfloat16): native.ENTRIES["pillar_scatter_max_bwd_bf16"],
    (True, torch.float32): native.ENTRIES["scatter_max_bwd_f32"],
    (True, torch.bfloat16): native.ENTRIES["scatter_max_bwd_bf16"]}


def pillar_scatter_max_bwd(g, feat, pid, canvas, sort=None):
    """Kernel `pillar_scatter_max_bwd` (contract of
    `pillar_scatter_max_bwd_plain`), f32 or bf16 (C even; g, feat and
    canvas of one dtype).  `sort` is the scratch that
    `pillar_scatter_max(feat, pid, S, keep_sort=True)` returned beside this
    canvas: the kernel counts the ties on its per-row point lists (and
    writes its partials region, which the forward no longer reads).
    Without it the kernel sorts the points itself first, as the forward
    does.  CPU tensors take the plain version (on the sort, where one is
    given); on the card any other dtype raises."""
    return _canvas_bwd("pillar_scatter_max_bwd", False, g, feat, pid, canvas,
                       sort)


def scatter_max_bwd(g, feat, pid, canvas, sort=None):
    """Kernel `scatter_max_bwd` (contract of `scatter_max_bwd_plain`), the
    gradient of `scatter_max`, as `pillar_scatter_max_bwd` takes its
    arguments; `sort` is `scatter_max(..., keep_sort=True)`'s scratch."""
    return _canvas_bwd("scatter_max_bwd", True, g, feat, pid, canvas, sort)


def _canvas_bwd(name, zero_init, g, feat, pid, canvas, sort):
    dev = feat.get_device()
    entry = _BWD_ENTRY.get((zero_init, feat.dtype))
    if not (feat.is_cuda and entry is not None and g.dtype is feat.dtype
            and canvas.dtype is feat.dtype and pid.dtype is torch.int32
            and feat.dim() == 2 and pid.shape == feat.shape[:1]
            and g.shape == canvas.shape and canvas.dim() == 2
            and canvas.shape[1] == feat.shape[1]
            and (feat.element_size() == 4 or feat.shape[1] % 2 == 0)
            and all(t.get_device() == dev for t in (g, pid, canvas))
            and all(t.is_contiguous() for t in (g, feat, pid, canvas))):
        if feat.device.type == "cpu":
            if sort is None:
                return pillar_scatter_max_bwd_plain(g, feat, pid, canvas,
                                                    zero_init)
            return pillar_scatter_max_bwd_sorted_plain(
                g, feat, canvas, *read_canvas_sort(
                    sort, feat.shape[0], feat.shape[1], canvas.shape[0],
                    feat.element_size()), zero_init)
        raise ValueError(
            f"{name}: g {g.dtype} {tuple(g.shape)}, feat "
            f"{feat.dtype} {tuple(feat.shape)}, pid {pid.dtype} "
            f"{tuple(pid.shape)}, canvas {canvas.dtype} "
            f"{tuple(canvas.shape)}: one dtype, f32 or bf16 (C even), int32 "
            "pid, contiguous, on one CUDA device")
    N, C = feat.shape
    S = canvas.shape[0]
    nbytes = canvas_scratch_bytes(N, C, S, feat.element_size())
    if sort is None:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=feat.device)
    elif (sort.dtype is torch.uint8 and sort.get_device() == dev
          and sort.numel() >= nbytes and sort.is_contiguous()):
        scratch = sort
    else:
        raise ValueError(f"{name}: sort {sort.dtype} "
                         f"{tuple(sort.shape)} on {sort.device}: the "
                         f"forward's uint8 scratch of {nbytes} bytes")
    out = torch.empty_like(feat)
    native.launch(entry, dev, g.data_ptr(), feat.data_ptr(), pid.data_ptr(),
                  canvas.data_ptr(), out.data_ptr(), N, C, S,
                  scratch.data_ptr(), scratch.numel(), int(sort is not None))
    return out


class CanvasMax(torch.autograd.Function):
    """`pillar_scatter_max(feat, pid, S)`, f32 or bf16, with its gradient
    to feat (`pillar_scatter_max_bwd` on the forward's sort, which the
    Function keeps, in feat's dtype); pid gets none."""

    @staticmethod
    def forward(ctx, feat, pid, num_segments: int):
        canvas, sort = pillar_scatter_max(feat, pid, num_segments,
                                          keep_sort=True)
        ctx.save_for_backward(feat, pid, canvas, sort)
        return canvas

    @staticmethod
    def backward(ctx, g):
        feat, pid, canvas, sort = ctx.saved_tensors
        return (pillar_scatter_max_bwd(g.contiguous(), feat, pid, canvas,
                                       sort), None, None)


class ScatterMax(torch.autograd.Function):
    """`scatter_max(feat, pid, S)`, the production eval route's canvas,
    with lav_tpu's gradient to feat (`scatter_max_bwd` on the forward's
    sort, in feat's dtype); pid gets none."""

    @staticmethod
    def forward(ctx, feat, pid, num_segments: int):
        canvas, sort = scatter_max(feat, pid, num_segments, keep_sort=True)
        ctx.save_for_backward(feat, pid, canvas, sort)
        return canvas

    @staticmethod
    def backward(ctx, g):
        feat, pid, canvas, sort = ctx.saved_tensors
        return (scatter_max_bwd(g.contiguous(), feat, pid, canvas, sort),
                None, None)


class PallasEvalMax(torch.autograd.Function):
    """`pillar_scatter_max(feat, pid, S)` on the use_pallas=True eval
    route, which lav_tpu cannot differentiate (`jax.grad` through
    `pillar_scatter_max_pallas` fails): the forward runs, the backward
    raises."""

    @staticmethod
    def forward(ctx, feat, pid, num_segments: int):
        return pillar_scatter_max(feat, pid, num_segments)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "PointPillar: the use_pallas=True eval route (kernel "
            "pillar_scatter_max, lav_tpu's pillar_scatter_max_pallas) has no "
            "gradient, as in lav_tpu; differentiate the production route "
            "(use_pallas=False) or train mode")


# csrc/pillar_scatter_max.cu's kTile, kHot, kGroupPoints and kAlign
CANVAS_TILE, CANVAS_HOT, CANVAS_GROUP_POINTS, CANVAS_ALIGN = 4096, 64, 32, 256


def canvas_layout(n: int, C: int, num_segments: int, elem: int) -> dict:
    """The scratch buffer of the canvas max for n points of C channels of
    `elem` bytes into num_segments rows: the `Layout` of
    csrc/pillar_scatter_max.cu, each array's byte offset (each aligned to
    CANVAS_ALIGN), and `total` bytes: meta (hot rows, their chunks, the
    points a chunk), counts (a row's exclusive prefix within its tile of
    CANVAS_TILE rows, once scanned), chunks done, tile sums (the tiles'
    exclusive prefix, once scanned), ranks, indices (the points placed by
    row), hot rows, their first chunks, partial maxima (or, in the
    backward, a chunk's tie counts).  `zeroed` ends the arrays the sort
    zeroes.  Also `tiles`, `max_hot`, `max_chunks`."""
    at = 0

    def take(nbytes):
        nonlocal at
        start = at
        at = -(-(at + nbytes) // CANVAS_ALIGN) * CANVAS_ALIGN
        return start

    tiles = -(-(num_segments + 1) // CANVAS_TILE)
    max_hot = n // (CANVAS_HOT + 1) + 1
    max_chunks = n // CANVAS_GROUP_POINTS + max_hot
    L = dict(tiles=tiles, max_hot=max_hot, max_chunks=max_chunks)
    L["meta"] = take(16)
    L["cnt"] = take(4 * tiles * CANVAS_TILE)
    L["done"] = take(4 * max_hot)
    L["zeroed"] = at
    L["tile_sum"] = take(4 * tiles)
    L["rank"] = take(4 * n)
    L["idx"] = take(4 * n)
    L["hot_rows"] = take(4 * max_hot)
    L["hot_start"] = take(4 * max_hot)
    L["partials"] = take(max_chunks * C * elem)
    L["total"] = at
    return L


def canvas_scratch_bytes(n: int, C: int, num_segments: int,
                         elem: int) -> int:
    """Bytes of the scratch buffer the canvas max takes (`canvas_layout`)."""
    return canvas_layout(n, C, num_segments, elem)["total"]


def canvas_chunk(C: int, elem: int) -> int:
    """The points of a hot row's chunk when every pointer is 16-byte
    aligned: a block of 256 threads, a 16-byte piece of the row (8 or 4
    bytes if the row's bytes are no multiple of 16) a thread, its rows of
    threads 32 points each (csrc/pillar_scatter_max.cu's `rows_block`)."""
    row = C * elem
    word = 16 if row % 16 == 0 else 8 if row % 8 == 0 else 4
    x = min(row // word, 256)
    return 256 // x * CANVAS_GROUP_POINTS


def _i32(buf, offset: int, count: int):
    return buf[offset:offset + 4 * count].view(torch.int32)


def canvas_sort_plain(pid, n: int, C: int, num_segments: int, elem: int):
    """Plain version of the canvas max's sort (csrc/pillar_scatter_max.cu
    passes 1-3): the scratch (uint8, `canvas_layout`) as the kernel leaves
    it, its points in index order within a row (the kernel's order within
    a row varies) and its hot rows in row order (the kernel's in any), the
    chunks of `canvas_chunk` points; partial maxima and chunks done are
    left 0."""
    L = canvas_layout(n, C, num_segments, elem)
    buf = torch.zeros(L["total"], dtype=torch.uint8, device=pid.device)
    p = pid.long()
    ok = (p >= 0) & (p < num_segments)
    tiles = L["tiles"]
    counts = torch.bincount(p[ok], minlength=tiles * CANVAS_TILE)
    per_tile = counts.reshape(tiles, CANVAS_TILE)
    local = per_tile.cumsum(1) - per_tile
    tile_tot = per_tile.sum(1)
    order = torch.nonzero(ok).flatten()
    order = order[torch.argsort(p[order], stable=True)]
    offsets = (local + (tile_tot.cumsum(0) - tile_tot)[:, None]).flatten()
    rank = torch.zeros(n, dtype=torch.int64, device=pid.device)
    rank[order] = torch.arange(order.numel(), device=pid.device) - offsets[
        p[order]]
    chunk = canvas_chunk(C, elem)
    hot = torch.nonzero(counts > CANVAS_HOT).flatten()
    chunks = -(-counts[hot] // chunk)
    _i32(buf, L["cnt"], tiles * CANVAS_TILE)[:] = local.flatten()
    _i32(buf, L["tile_sum"], tiles)[:] = tile_tot.cumsum(0) - tile_tot
    _i32(buf, L["rank"], n)[:] = rank
    _i32(buf, L["idx"], order.numel())[:] = order
    _i32(buf, L["hot_rows"], hot.numel())[:] = hot
    _i32(buf, L["hot_start"], hot.numel())[:] = chunks.cumsum(0) - chunks
    _i32(buf, L["meta"], 3)[:] = torch.tensor(
        [hot.numel(), int(chunks.sum()), chunk], dtype=torch.int32)
    return buf


def read_canvas_sort(sort, n: int, C: int, num_segments: int, elem: int):
    """The canvas max's sort in its scratch `sort` (`canvas_layout`) ->
    (offsets (S + 1,), idx (offsets[-1],)), int64: row r's points are
    idx[offsets[r]:offsets[r + 1]]; a row's offset is its prefix within its
    tile plus its tile's prefix."""
    L = canvas_layout(n, C, num_segments, elem)
    rows = torch.arange(num_segments + 1, device=sort.device)
    offsets = (_i32(sort, L["cnt"], num_segments + 1).long()
               + _i32(sort, L["tile_sum"], L["tiles"]).long()[
                   rows // CANVAS_TILE])
    return offsets, _i32(sort, L["idx"], n)[:int(offsets[-1])].long()


# csrc/pillar_scatter.cu's kTileItems, kDigits, kBits and kAlign
ADD_TILE, ADD_DIGITS, ADD_BITS, ADD_ALIGN = 2048, 256, 8, 256


def scatter_add_layout(n: int, num_segments: int) -> dict:
    """The scratch buffer of kernel `scatter_add` for n points into
    num_segments rows: csrc/pillar_scatter.cu's `AddLayout`, each array's
    byte offset (aligned to ADD_ALIGN) and `total` bytes: two key and two
    index arrays of n (the radix sort's ping-pong), the (digit, tile)
    counts of each pass and each pass's digit totals.  Also `tiles` and
    `passes` (8 bits of the row a pass)."""
    at = 0

    def take(nbytes):
        nonlocal at
        start = at
        at = -(-(at + nbytes) // ADD_ALIGN) * ADD_ALIGN
        return start

    tiles = -(-n // ADD_TILE)
    bits = max(1, (num_segments - 1).bit_length())
    passes = -(-bits // ADD_BITS)
    L = dict(tiles=tiles, passes=passes)
    for key in ("keys0", "vals0", "keys1", "vals1"):
        L[key] = take(4 * n)
    L["hist"] = take(4 * passes * ADD_DIGITS * tiles)
    L["totals"] = take(4 * passes * ADD_DIGITS)
    L["total"] = at
    return L


def scatter_add_scratch_bytes(n: int, num_segments: int) -> int:
    """Bytes of the scratch buffer kernel `scatter_add` takes."""
    return scatter_add_layout(n, num_segments)["total"]


def _scatter(name, entry, plain, feat, pid, num_segments: int,
             canvas: bool, keep_sort: bool = False):
    """Launch `entry` (kernel `name`) on (feat, pid); CPU tensors take
    `plain`.  Each takes a scratch buffer.  A canvas max writes every row
    of an uninitialised output (scratch `canvas_scratch_bytes`, returned
    beside the canvas with `keep_sort`); the add sums into a zeroed one
    (scratch `scatter_add_scratch_bytes`).
    The checks the scatters share (int32 pid (N,) beside feat (N, C) on
    its device, both contiguous, bf16 rows in 4-byte channel pairs) are
    one test on the fast path; `_refuse` says what is wrong."""
    dev = feat.get_device()
    if not (feat.is_cuda and entry is not None and pid.dtype is torch.int32
            and feat.dim() == 2 and pid.dim() == 1
            and pid.shape[0] == feat.shape[0] and pid.get_device() == dev
            and feat.is_contiguous() and pid.is_contiguous()
            and (feat.dtype is not torch.bfloat16
                 or (feat.shape[1] % 2 == 0 and feat.data_ptr() % 4 == 0))):
        if feat.device.type == "cpu":
            out = plain(feat, pid, num_segments)
            if not keep_sort:
                return out
            return out, canvas_sort_plain(pid, *feat.shape, num_segments,
                                          feat.element_size())
        _refuse(name, entry, feat, pid)
    N, C = feat.shape
    if canvas:
        out = feat.new_empty((num_segments, C))
        nbytes = canvas_scratch_bytes(N, C, num_segments, feat.element_size())
    else:
        out = feat.new_zeros((num_segments, C))
        nbytes = scatter_add_scratch_bytes(N, num_segments)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=feat.device)
    native.launch(entry, dev, feat.data_ptr(), pid.data_ptr(),
                  out.data_ptr(), N, C, num_segments, scratch.data_ptr(),
                  scratch.numel())
    return (out, scratch) if keep_sort else out


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
    -> (num_segments, C) f32 per-segment sums, each added in point order
    from 0 (index_add_ on the CPU); ids outside the range are dropped."""
    ok = (pid >= 0) & (pid < num_segments)
    acc = feat.new_zeros((num_segments, feat.shape[-1]))
    return acc.index_add_(0, pid.long()[ok], feat[ok])


_K3_ENTRY = {("max", torch.bfloat16): native.ENTRIES["scatter_max_bf16"],
             ("max", torch.float32): native.ENTRIES["scatter_max_f32"],
             ("add", torch.float32): native.ENTRIES["scatter_add_f32"]}


def scatter_max(feat, pid, num_segments: int, keep_sort: bool = False):
    """Kernel `scatter_max` (contract of `scatter_max_plain`), the canvas
    of the production route.  CPU tensors take the plain version.  With
    `keep_sort`, -> (canvas, sort), as `pillar_scatter_max` returns them,
    for `scatter_max_bwd`."""
    if native.EXPORTING and not keep_sort:
        return _OPS["scatter_max"](feat, pid, num_segments)
    return _scatter_max(feat, pid, num_segments, keep_sort)


def _scatter_max(feat, pid, num_segments: int, keep_sort=False):
    return _scatter("scatter_max", _K3_ENTRY.get(("max", feat.dtype)),
                    scatter_max_plain, feat, pid, num_segments, canvas=True,
                    keep_sort=keep_sort)


def scatter_add(feat, pid, num_segments: int):
    """Kernel `scatter_add` (contract of `scatter_add_plain`, bit for bit),
    the decoration sums.  CPU tensors take the plain version."""
    if native.EXPORTING:
        return _OPS["scatter_add"](feat, pid, num_segments)
    return _scatter_add(feat, pid, num_segments)


def _scatter_add(feat, pid, num_segments: int):
    return _scatter("scatter_add", _K3_ENTRY.get(("add", feat.dtype)),
                    scatter_add_plain, feat, pid, num_segments, canvas=False)


def _rows_op(direct):
    """A scatter (feat (N, C), pid (N,), num_segments) -> (num_segments,
    C) as a custom op's implementation."""
    def impl(feat: torch.Tensor, pid: torch.Tensor,
             num_segments: int) -> torch.Tensor:
        return direct(feat, pid, num_segments)
    return impl


def _rows_fake(feat, pid, num_segments):
    return feat.new_empty((num_segments, feat.shape[1]))


# the tick's scatters as custom ops (`native.custom_op`), for export
_OPS = {name: native.custom_op(name, _rows_op(direct), _rows_fake)
        for name, direct in (("pillar_scatter_max", _pillar_scatter_max),
                             ("scatter_max", _scatter_max),
                             ("scatter_add", _scatter_add))}


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
        if torch.is_grad_enabled() and feat.requires_grad:
            canvas_max = (CanvasMax if self.training else
                          PallasEvalMax if use_pallas else ScatterMax)
            canvas = canvas_max.apply(feat.contiguous(), canvas_pid, B * G)
        else:   # no gradient: the kernel alone (as a custom op in export)
            canvas = (pillar_scatter_max if neg_init else scatter_max)(
                feat.contiguous(), canvas_pid, B * G)
        return canvas.reshape(B, ny, nx, C)
