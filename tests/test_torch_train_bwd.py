"""The host-side pieces of the distillation step's two backward kernels,
on the CPU.

* `crop_shared_bwd` is a gather: each source cell sums the output pixels
  of a window that `crop_bwd_map` (the plain version of the kernel's
  first pass: an affine fit of each crop's grid, its largest miss and its
  inverse) and `crop_bwd_window` (the window of one cell, rounded as the
  kernel rounds it) give; the kernel tests the candidates of a tile of
  cells once, in the tile's window (`crop_bwd_tile_window`, the union of
  its cells').  Every tap of weight above 0 of every output pixel must
  fall in its cell's window and its tile's, and every cell's window in
  its tile's: on grids from the port's `crop_theta` and `affine_grid` at
  rotations over the full circle, at another scale, straddling each
  border, wholly outside, on a 157 x 163 source, and on grids that are
  not affine (the fit's miss widens the window) or degenerate (every
  pixel a candidate).  A Python walk of the gather (crop, then window
  row, then column) over the cells' windows gives the plain version's
  gradient within chip_smoke.py's CROP_BWD_RTOL of each cell's sum of |g
  w| (the summation order differs), and a walk of the kernel's tiles gives
  the cell walk's bits, f32 and bf16.
* `pillar_scatter_max_bwd` counts ties on the forward's counting sort:
  `canvas_layout` against csrc/pillar_scatter_max.cu's `Layout`, array by
  array; `canvas_sort_plain` laid out as the kernel leaves its scratch
  and read back by `read_canvas_sort`; the plain version on the sort
  exactly equal to the plain version on the ids, on chip_smoke.py's
  crafted cases (ties of 2, 3, 40 equal maxima, ties at 0, dropped ids,
  empty rows, C = 4, 6, 64, a hot row of 5,000 points); and `CanvasMax` on
  the CPU, its forward's sort handed to its backward, against `jax.grad`
  of lav_tpu's train route.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from lav_tpu_torch.core import warp
from lav_tpu_torch.ops import pillar as P
from lav_tpu_torch.utils import native
from tests.test_torch_native import _layout_scope
from tests.test_torch_train_grad import _canvas_case
from tests.torch_parity import assert_close

@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grid(H, W, crop, locs, oris, ppm=2.0):
    """(1, K, crop, crop, 2) from the port's crop_theta and affine_grid."""
    theta = warp.crop_theta(torch.tensor(locs, dtype=torch.float32),
                            torch.tensor(oris, dtype=torch.float32), H, W,
                            ppm, crop, 0.0, 0.75)
    return warp.affine_grid(theta, crop, crop)[None]


def _taps(grid, H, W):
    """Every tap of weight above 0 -> (crop, u, v, x, y) int64 rows, with
    the forward's f32 arithmetic."""
    B, K, Ho, Wo, _ = grid.shape
    ix = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.clamp(torch.floor(ix), 0, W - 2)
    y0 = torch.clamp(torch.floor(iy), 0, H - 2)
    crop, v, u = torch.meshgrid(torch.arange(B * K), torch.arange(Ho),
                                torch.arange(Wo), indexing="ij")
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            wy = torch.clamp(1.0 - torch.abs(iy - (y0 + dy)), min=0.0)
            wx = torch.clamp(1.0 - torch.abs(ix - (x0 + dx)), min=0.0)
            hit = (wy * wx).reshape(B * K, Ho, Wo) > 0
            rows.append(torch.stack([
                crop[hit], u[hit], v[hit],
                (x0 + dx).reshape(B * K, Ho, Wo)[hit].long(),
                (y0 + dy).reshape(B * K, Ho, Wo)[hit].long()], -1))
    return torch.cat(rows)


def _assert_windows_hold_taps(grid, H, W):
    Ho, Wo = grid.shape[2:4]
    cmap = warp.crop_bwd_map(grid, H, W)
    taps = _taps(grid, H, W)
    c, u, v, x, y = taps.unbind(-1)
    u0, u1, v0, v1 = warp.crop_bwd_window(cmap[c], x, y, Ho, Wo)
    inside = (u0 <= u) & (u <= u1) & (v0 <= v) & (v <= v1)
    assert bool(inside.all()), taps[~inside][:5]
    return cmap, taps


def _half_side(cmap):
    return float(cmap[:, 6:].max())


ROTATIONS = [0.0, math.pi / 4, math.pi / 2, 3 * math.pi / 4, math.pi,
             -3 * math.pi / 4, 2.0, -0.35]


@pytest.mark.parametrize("ori", ROTATIONS)
def test_crop_windows_hold_every_tap_at_any_rotation(ori):
    """The step's scale (96 from 160 at 2 px/m, here 24 from 40) with each
    of four crops turned by `ori` plus a multiple of pi/2; about one source
    pixel an output pixel, so a window of at most 5 x 5 candidates."""
    locs = [[1.0, -2.0], [-3.0, 0.5], [0.0, 0.0], [2.5, 2.5]]
    oris = [ori + q * math.pi / 2 for q in range(4)]
    cmap, taps = _assert_windows_hold_taps(_grid(40, 40, 24, locs, oris),
                                           40, 40)
    assert taps.shape[0] > 4 * 24 * 24
    assert _half_side(cmap) < 3.0


@pytest.mark.parametrize("H,W,crop,ppm", [(160, 160, 64, 2.0),
                                          (157, 163, 96, 2.0),
                                          (40, 40, 24, 4.0),
                                          (40, 40, 24, 1.0)])
def test_crop_windows_hold_every_tap_at_other_scales_and_sizes(H, W, crop,
                                                               ppm):
    """Crop 64 from 160, a 157 x 163 source (H, W no multiple of a tile),
    and the map's translations at other pixels per meter."""
    r = np.random.default_rng(H + crop)
    locs = r.uniform(-4, 4, (5, 2)).tolist()
    oris = r.uniform(-math.pi, math.pi, 5).tolist()
    _assert_windows_hold_taps(_grid(H, W, crop, locs, oris, ppm), H, W)


@pytest.mark.parametrize("side", ["top", "bottom", "left", "right",
                                  "corner", "outside"])
def test_crop_windows_hold_every_tap_across_the_border(side):
    """Crops that straddle each border (their taps clamped into [0, W-2]:
    ix in (-1, 0) weighs tap 0, ix in [W-1, W) tap W-1), the corner every
    far tap is clamped to, and a crop wholly outside, whose window is
    empty wherever it has no tap."""
    H = 40
    at = {"top": [9.5, 0.0], "bottom": [-9.5, 0.0], "left": [0.0, -9.5],
          "right": [0.0, 9.5], "corner": [9.5, 9.5],
          "outside": [500.0, -700.0]}[side]
    locs = [at, [at[0] * 0.95, at[1] * 0.95]]
    oris = [0.3, -2.5]
    grid = _grid(H, H, 24, locs, oris)
    cmap, taps = _assert_windows_hold_taps(grid, H, H)
    if side == "outside":
        assert taps.shape[0] == 0
        cells = torch.cartesian_prod(torch.arange(H), torch.arange(H))
        u0, u1, v0, v1 = warp.crop_bwd_window(cmap[0], cells[:, 0],
                                              cells[:, 1], 24, 24)
        assert bool(((u0 > u1) | (v0 > v1)).all())
    else:
        x, y = taps[:, 3], taps[:, 4]
        assert bool(((x == 0) | (x == H - 1) | (y == 0) | (y == H - 1))
                    .any())


def test_crop_windows_widen_for_a_grid_that_is_not_affine():
    """A grid bent away from its affine fit by up to 1.5 source pixels:
    the fit's miss widens every window enough, so the gather stays
    right for any grid, only slower."""
    grid = _grid(40, 40, 24, [[0.5, -1.0]], [0.7])
    r = np.random.default_rng(3)
    bend = torch.from_numpy(r.uniform(-1.5, 1.5, grid.shape).astype(
        np.float32)) * 2 / 39
    bend[:, :, 0, 0] = bend[:, :, 0, -1] = bend[:, :, -1, 0] = 0
    cmap, _ = _assert_windows_hold_taps(grid + bend, 40, 40)
    flat, _ = _assert_windows_hold_taps(grid, 40, 40)
    assert float(cmap[0, 6]) > float(flat[0, 6]) + 1.0


@pytest.mark.parametrize("case", ["one row", "one column", "zero scale",
                                  "nan"])
def test_degenerate_crops_take_every_pixel(case):
    """A 1-pixel side, a map of scale 0 and a NaN position give an
    infinite window (every output pixel a candidate), never a wrong
    one."""
    grid = _grid(40, 40, 24, [[0.5, -1.0]], [0.7])
    if case == "one row":
        grid = grid[:, :, :1].contiguous()
    elif case == "one column":
        grid = grid[:, :, :, :1].contiguous()
    elif case == "zero scale":
        grid = torch.zeros_like(grid) + 0.1
    else:
        grid = grid.clone()
        grid[0, 0, 3, 4, 0] = float("nan")
    cmap = warp.crop_bwd_map(grid, 40, 40)
    assert torch.isinf(cmap[:, 6:]).all()
    assert not cmap[:, :6].any()
    Ho, Wo = grid.shape[2:4]
    u0, u1, v0, v1 = warp.crop_bwd_window(cmap, torch.tensor([7]),
                                          torch.tensor([9]), Ho, Wo)
    assert (int(u0), int(u1), int(v0), int(v1)) == (0, Wo - 1, 0, Ho - 1)
    _assert_windows_hold_taps(grid, 40, 40)


def test_crop_bwd_tile_is_the_kernel_tile():
    """CROP_BWD_TILE is csrc/crop_shared_bwd.cu's kTileX x kTileY."""
    src = (native.CSRC_DIR / "crop_shared_bwd.cu").read_text()
    assert tuple(int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))
                 for name in ("kTileX", "kTileY")) == warp.CROP_BWD_TILE


TILE_CASES = ["rotations", "157 x 163", "4 px/m", "1 px/m", "top", "left",
              "corner", "outside", "bent", "one row", "zero scale", "nan"]


def _tile_case(case):
    """(grid, H, W) of the window tests above, by name."""
    if case == "rotations":
        locs = [[(-1) ** i * 3.0, 2.0 - i] for i in range(len(ROTATIONS))]
        return _grid(40, 40, 24, locs, ROTATIONS), 40, 40
    if case == "157 x 163":
        r = np.random.default_rng(7)
        return (_grid(157, 163, 96, r.uniform(-4, 4, (3, 2)).tolist(),
                      r.uniform(-math.pi, math.pi, 3).tolist()), 157, 163)
    if case.endswith("px/m"):
        ppm = float(case.split()[0])
        return _grid(40, 40, 24, [[1.0, -2.0], [0.0, 0.5]], [0.4, -2.0],
                     ppm), 40, 40
    at = {"top": [9.5, 0.0], "left": [0.0, -9.5], "corner": [9.5, 9.5],
          "outside": [500.0, -700.0]}.get(case, [0.5, -1.0])
    grid = _grid(40, 40, 24, [at, [at[0] * 0.95, at[1] * 0.95]],
                 [0.3, -2.5])
    if case == "bent":
        r = np.random.default_rng(3)
        bend = torch.from_numpy(r.uniform(-1.5, 1.5, grid.shape).astype(
            np.float32)) * 2 / 39
        bend[:, :, 0, 0] = bend[:, :, 0, -1] = bend[:, :, -1, 0] = 0
        grid = grid + bend
    elif case == "one row":
        grid = grid[:, :, :1].contiguous()
    elif case == "zero scale":
        grid = torch.zeros_like(grid) + 0.1
    elif case == "nan":
        grid = grid.clone()
        grid[0, 0, 3, 4, 0] = float("nan")
    return grid, 40, 40


def _tile_of(x, y, tile, H, W):
    """The corners (xa, xb, ya, yb) of the tile holding cell (x, y)."""
    TX, TY = tile
    xa, ya = x // TX * TX, y // TY * TY
    return (xa, torch.clamp(xa + TX - 1, max=W - 1), ya,
            torch.clamp(ya + TY - 1, max=H - 1))


@pytest.mark.parametrize("tile", [warp.CROP_BWD_TILE, (8, 8)])
@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_windows_hold_every_tap_and_every_cells_window(case, tile):
    """Every tap of weight above 0 lies in its tile's window (no hit lost),
    and the tile's window holds each of its cells' windows: at rotations
    over the full circle, a 157 x 163 source, other scales, across the
    borders and outside, on a bent grid and on degenerate ones (every
    pixel a candidate)."""
    grid, H, W = _tile_case(case)
    Ho, Wo = grid.shape[2:4]
    cmap = warp.crop_bwd_map(grid, H, W)
    c, u, v, x, y = _taps(grid, H, W).unbind(-1)
    u0, u1, v0, v1 = warp.crop_bwd_tile_window(
        cmap[c], *_tile_of(x, y, tile, H, W), Ho, Wo)
    assert bool(((u0 <= u) & (u <= u1) & (v0 <= v) & (v <= v1)).all())
    assert (case == "outside") == (c.numel() == 0)
    cc, yy, xx = torch.meshgrid(torch.arange(cmap.shape[0]),
                                torch.arange(H), torch.arange(W),
                                indexing="ij")
    cell = warp.crop_bwd_window(cmap[cc], xx, yy, Ho, Wo)
    box = warp.crop_bwd_tile_window(cmap[cc], *_tile_of(xx, yy, tile, H, W),
                                    Ho, Wo)
    empty = (cell[0] > cell[1]) | (cell[2] > cell[3])
    held = ((box[0] <= cell[0]) & (cell[1] <= box[1]) & (box[2] <= cell[2])
            & (cell[3] <= box[3]))
    assert bool((held | empty).all())


def _walk_setup(g, grid, H, W):
    """What both walks read: the map, each output pixel's position, its
    clamped tap origin, and g by crop."""
    B, K, Ho, Wo, C = g.shape
    ix = ((grid[..., 0] + 1.0) * 0.5 * (W - 1)).reshape(B * K, Ho, Wo)
    iy = ((grid[..., 1] + 1.0) * 0.5 * (H - 1)).reshape(B * K, Ho, Wo)
    x0 = torch.clamp(torch.floor(ix), 0, W - 2)
    y0 = torch.clamp(torch.floor(iy), 0, H - 2)
    return (warp.crop_bwd_map(grid, H, W), ix, iy, x0, y0,
            g.reshape(B * K, Ho, Wo, C))


def _term(gk, ix, iy, x0, y0, c, v, u, x, y):
    """The term output pixel (u, v) of crop c adds to cell (x, y), as the
    kernel's `axpy` forms it (the weight and the product rounded to bf16
    for a bf16 g), or None where the cell is no tap of weight above 0."""
    dx, dy = x - int(x0[c, v, u]), y - int(y0[c, v, u])
    if not (0 <= dx <= 1 and 0 <= dy <= 1):
        return None
    wx = torch.clamp(1.0 - torch.abs(ix[c, v, u] - (x0[c, v, u] + dx)),
                     min=0.0)
    wy = torch.clamp(1.0 - torch.abs(iy[c, v, u] - (y0[c, v, u] + dy)),
                     min=0.0)
    w = (wy * wx).to(gk.dtype).float()
    if w == 0:
        return None
    return (gk[c, v, u].float() * w).to(gk.dtype).float()


def _gather_walk(g, grid, H, W):
    """Kernel `crop_shared_bwd`'s gather walked cell by cell in Python:
    each cell sums the hits of each crop's window (row by row), terms
    formed as the kernel forms them and added in f32 in that order -> the
    f32 sums."""
    B, K, Ho, Wo, C = g.shape
    cmap, ix, iy, x0, y0, gk = _walk_setup(g, grid, H, W)
    out = torch.zeros((B, H, W, C))
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    for b in range(B):
        for k in range(K):
            c = b * K + k
            u0, u1, v0, v1 = warp.crop_bwd_window(cmap[c], xs, ys, Ho, Wo)
            for y in range(H):
                for x in range(W):
                    for v in range(int(v0[y, x]), int(v1[y, x]) + 1):
                        for u in range(int(u0[y, x]), int(u1[y, x]) + 1):
                            t = _term(gk, ix, iy, x0, y0, c, v, u, x, y)
                            if t is not None:
                                out[b, y, x] += t
    return out


def _tile_walk(g, grid, H, W, tile):
    """The kernel's walk as its blocks take it: per tile of `tile` cells
    and crop, the tile's window row by row, each candidate's four taps,
    each hit added to its cell in f32 -> the f32 sums."""
    B, K, Ho, Wo, C = g.shape
    cmap, ix, iy, x0, y0, gk = _walk_setup(g, grid, H, W)
    out = torch.zeros((B, H, W, C))
    TX, TY = tile
    for b in range(B):
        for ty in range(0, H, TY):
            for tx in range(0, W, TX):
                xb, yb = min(tx + TX, W) - 1, min(ty + TY, H) - 1
                for k in range(K):
                    c = b * K + k
                    u0, u1, v0, v1 = (int(t) for t in warp.crop_bwd_tile_window(
                        cmap[c], torch.tensor(tx), torch.tensor(xb),
                        torch.tensor(ty), torch.tensor(yb), Ho, Wo))
                    for v in range(v0, v1 + 1):
                        for u in range(u0, u1 + 1):
                            for dy in (0, 1):
                                for dx in (0, 1):
                                    x = int(x0[c, v, u]) + dx
                                    y = int(y0[c, v, u]) + dy
                                    if not (tx <= x <= xb and ty <= y <= yb):
                                        continue
                                    t = _term(gk, ix, iy, x0, y0, c, v, u,
                                              x, y)
                                    if t is not None:
                                        out[b, y, x] += t
    return out


def _walk_case(dtype, C=3):
    """Two items of two crops (one across the border, one outside), 12 x
    12 from 20 x 20."""
    r = np.random.default_rng(4)
    H, crop = 20, 12
    grid = torch.cat([_grid(H, H, crop, [[4.5, -0.5], [200.0, 0.0]],
                            [2.2, 0.0]),
                      _grid(H, H, crop, [[0.3, 0.2], [-1.0, 1.0]],
                            [-0.8, 3.1])])
    g = torch.from_numpy(r.normal(size=(2, 2, crop, crop, C)).astype(
        np.float32)).to(dtype)
    return g, grid, H


def test_the_gather_walk_gives_the_plain_gradient():
    """The walk over the windows is within chip_smoke.py's CROP_BWD_RTOL
    of each cell's sum of |g w| of the plain version (C = 3)."""
    g, grid, H = _walk_case(torch.float32)
    walk = _gather_walk(g, grid, H, H)
    ref = warp.grid_sample_shared_bwd(g, grid, H, H)
    mag = warp.grid_sample_shared_bwd(g.abs(), grid, H, H)
    assert bool(((walk - ref).abs() <= cs.CROP_BWD_RTOL * mag).all())
    assert float(walk[0].abs().max()) > 0 and int((mag == 0).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [warp.CROP_BWD_TILE, (8, 8)])
def test_the_tile_walk_gives_the_cell_walks_bits(dtype, tile):
    """The kernel's tiles add each cell's terms in the order the cell walk
    adds them (crop, then output row, then column), so the two give the
    same bits, f32 and bf16 (weights and products rounded to bf16), and
    the bf16 result, rounded once, is the plain version's within a bf16
    ulp beyond CROP_BWD_RTOL."""
    g, grid, H = _walk_case(dtype)
    tiles = _tile_walk(g, grid, H, H, tile)
    cells = _gather_walk(g, grid, H, H)
    assert torch.equal(tiles, cells)
    assert float(tiles.abs().max()) > 0
    if dtype == torch.bfloat16:
        ref = warp.grid_sample_shared_bwd(g, grid, H, H).float()
        mag = warp.grid_sample_shared_bwd(g.abs().float(), grid, H, H)
        out = tiles.to(dtype).float()
        big = torch.maximum(out.abs(), ref.abs()).clamp(min=2.0 ** -126)
        tol = (cs.CROP_BWD_RTOL * mag + cs.CROP_BWD_BF16_ULPS
               * torch.exp2(torch.floor(torch.log2(big)) - 7))
        assert bool(((out - ref).abs() <= tol).all())


# ---- the canvas max's sort ----

@pytest.mark.parametrize("n,C,rows,elem", [
    (65536, 64, 4 * 102400, 4),         # the distillation step's canvas
    (960000, 64, 16 * 102400, 2),       # the production canvas, bf16
    (0, 64, 10000, 2),
    (20000, 6, 10000, 4),
])
def test_canvas_layout_is_the_kernel_layout(n, C, rows, elem):
    scope, _ = _layout_scope(n, rows, C * elem)
    L = P.canvas_layout(n, C, rows, elem)
    for key, value in L.items():
        assert scope[key] == value, key


@pytest.mark.parametrize("C,elem,chunk", [(64, 4, 512), (64, 2, 1024),
                                          (6, 4, 85 * 32), (66, 2, 7 * 32)])
def test_canvas_chunk_is_the_rows_block(C, elem, chunk):
    """The forward's hot-row chunk with aligned pointers: 256 threads, a
    row of C * elem bytes in 16-, 8- or 4-byte pieces, 32 points a row of
    threads (64 f32 channels: 16 pieces, 16 rows, 512 points; 6: three
    8-byte pieces, 85 rows; 66 bf16: 33 4-byte pieces, 7 rows)."""
    assert P.canvas_chunk(C, elem) == chunk


def _sort_case(seed, n, S, C, hot=0):
    """pid (n,) int32 over half the rows (the rest empty), a tenth
    dropped (negative or past S), `hot` points in row 3."""
    r = np.random.default_rng(seed)
    pid = r.integers(0, S // 2, n)
    drop = r.uniform(size=n) < 0.1
    pid[drop] = np.where(r.uniform(size=drop.sum()) < 0.5, -1, S)
    pid[:hot] = 3
    return torch.from_numpy(pid.astype(np.int32))


@pytest.mark.parametrize("n,S,C,elem,hot", [(400, 50, 64, 4, 0),
                                             (6000, 9000, 6, 4, 5000),
                                             (3000, 5000, 64, 2, 200)])
def test_canvas_sort_plain_lays_out_the_rows(n, S, C, elem, hot):
    """The scratch as the kernel leaves it: each row's offset (prefix in
    its tile plus the tile's prefix), its points placed by row in index
    order, their ranks, the hot rows (above CANVAS_HOT points) with their
    first chunks and the meta (hot rows, chunks, points a chunk)."""
    pid = _sort_case(n + S, n, S, C, hot)
    buf = P.canvas_sort_plain(pid, n, C, S, elem)
    L = P.canvas_layout(n, C, S, elem)
    assert buf.dtype == torch.uint8 and buf.numel() == L["total"]
    offsets, idx = P.read_canvas_sort(buf, n, C, S, elem)
    p = pid.long()
    ok = (p >= 0) & (p < S)
    counts = torch.bincount(p[ok], minlength=S)
    assert torch.equal(offsets, torch.cat([torch.zeros(1, dtype=torch.long),
                                           counts.cumsum(0)]))
    assert torch.equal(idx, torch.nonzero(ok).flatten()[
        torch.argsort(p[ok], stable=True)])
    rank = P._i32(buf, L["rank"], n).long()
    assert torch.equal(offsets[p[idx]] + rank[idx],
                       torch.arange(idx.numel()))
    chunk = P.canvas_chunk(C, elem)
    meta = P._i32(buf, L["meta"], 3).tolist()
    hot_rows = torch.nonzero(counts > P.CANVAS_HOT).flatten()
    chunks = -(-counts[hot_rows] // chunk)
    assert meta == [hot_rows.numel(), int(chunks.sum()), chunk]
    assert P._i32(buf, L["hot_rows"], meta[0]).tolist() == hot_rows.tolist()
    assert P._i32(buf, L["hot_start"], meta[0]).tolist() == (
        chunks.cumsum(0) - chunks).tolist()
    if hot:
        assert 3 in hot_rows.tolist()


@pytest.mark.parametrize("case", range(5))
def test_the_backward_on_the_sort_equals_the_plain_version(case):
    """chip_smoke.py's crafted cases (ties of 2, 3 and 40 equal maxima,
    ties at 0, dropped ids, empty rows, C = 4, 6, 64; a hot row of 5,000
    points, 300 of them tied, among the step's 4 x 16384; hot rows of 255
    to 1,000 tied points) on the CPU, their sort from the forward
    (`canvas_sort_plain`)."""
    label, g, feat, pid, canvas, sort = cs._canvas_bwd_cases(
        torch, torch.device("cpu"))[case]
    ref = P.pillar_scatter_max_bwd_plain(g, feat, pid, canvas)
    out = P.pillar_scatter_max_bwd(g, feat, pid, canvas, sort)
    assert torch.equal(out, ref)
    assert torch.equal(P.pillar_scatter_max_bwd(g, feat, pid, canvas), ref)
    ok = (pid >= 0) & (pid < canvas.shape[0])
    assert bool((out[~ok] == 0).all())
    if "hot" in label:   # 300 points share each channel's max of row 17
        assert torch.equal(out[:300], (g[17] * (1.0 / 300)).expand(300, -1))
        assert int((pid == 17).sum()) == 5000


def test_canvas_max_hands_its_forward_sort_to_its_backward(monkeypatch):
    """`CanvasMax` on the CPU: the backward receives the forward's sort,
    and the gradient equals jax.grad of lav_tpu's train route (the case of
    tests/test_torch_train_grad.py), exactly."""
    feat, pid, keep, g, (B, Pn, C, nx, ny) = _canvas_case()
    G = nx * ny
    neg = jnp.asarray(-1e30, jnp.float32)

    def j_canvas(f):   # lav_tpu ops/pillar.py:516-522
        f = jnp.where(jnp.asarray(keep)[..., None], f, neg)
        pid_flat = (jnp.asarray(pid) + jnp.arange(B)[:, None] * (G + 1))
        canvas = jnp.full((B * (G + 1), C), neg).at[
            pid_flat.reshape(-1)].max(f.reshape(-1, C))
        canvas = jnp.where(canvas > neg, canvas, 0.0)
        return canvas.reshape(B, G + 1, C)[:, :G].reshape(B, ny, nx, C)

    _, vjp = jax.vjp(j_canvas, jnp.asarray(feat))
    (d_ref,) = vjp(jnp.asarray(g))
    seen = []
    real = P.pillar_scatter_max_bwd

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(P, "pillar_scatter_max_bwd", spy)
    canvas_pid = np.where(keep, pid + np.arange(B)[:, None] * G, B * G)
    f = torch.from_numpy(feat).reshape(-1, C).requires_grad_(True)
    out = P.CanvasMax.apply(f, torch.from_numpy(canvas_pid.astype(
        np.int32)).reshape(-1), B * G)
    out.backward(torch.from_numpy(g).reshape(-1, C))
    assert len(seen) == 1 and seen[0][4] is not None
    assert seen[0][4].dtype == torch.uint8
    assert_close("train.canvas_max_bwd_sorted", f.grad.reshape(B, Pn, C),
                 d_ref, atol=0)
