"""Kernel `crop_shared`'s plain forms (`crop_tiled` in
csrc/crop_shared.cu) as pure Python, with the kernel's constants read from
its source: which output element each thread writes and where its taps
lie.  The kernel runs only on the card; these tests hold its index
arithmetic on the CPU.

* A thread's walk over its tile (the kernel's recurrence, stepped here as
  the kernel steps it) visits the tile's pieces in output order, each
  once, consecutive threads on consecutive pieces.
* Every output element is written exactly once, on the vector route (16
  bytes of channels a piece, 16-byte stores on 16-byte boundaries) and on
  the narrow route (a channel a piece), for C in {1, 3, 5, 9, 12, 384},
  crops of 37, 90, 96 and 192 (partial tiles), f32 and bf16, with aligned
  and unaligned pointers.
* Every tap lies in the source, for crops turned, far outside, and on
  non-finite grids.
"""

import math
import re

import pytest
import torch

from lav_tpu_torch.core import warp
from lav_tpu_torch.utils import native


def _constants():
    """kPlainThreads, kTileX and kNarrowTy as csrc/crop_shared.cu states
    them."""
    src = (native.CSRC_DIR / "crop_shared.cu").read_text()
    return tuple(int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))
                 for name in ("kPlainThreads", "kTileX", "kNarrowTy"))


THREADS, TILE_X, NARROW_TY = _constants()
NARROW, VECTOR = (TILE_X, NARROW_TY), (TILE_X, 1)


def _route(C, elem, src_addr, out_addr):
    """launch_plain's choice: (V, its tile (TX, TY))."""
    vmax = 16 // elem
    if C % vmax == 0 and (src_addr | out_addr) % 16 == 0:
        return vmax, VECTOR
    return 1, NARROW


def _walk(P, PIX):
    """The kernel's loop for each thread: its (pix, piece) visits, stepped
    by the recurrence in crop_tiled (dpix, dpiece, and the carry)."""
    dpix, dpiece = THREADS // P, THREADS % P
    visits = []
    for tid in range(THREADS):
        pix, piece = tid // P, tid % P
        while pix < PIX:
            visits.append((tid, pix, piece))
            piece += dpiece
            pix += dpix
            if piece >= P:
                piece -= P
                pix += 1
    return visits


@pytest.mark.parametrize("tile", [NARROW, VECTOR])
@pytest.mark.parametrize("P", [1, 3, 5, 9, 12, 48, 96, 384, 256, 257])
def test_each_thread_walks_its_pieces_in_output_order(P, tile):
    PIX = tile[0] * tile[1]
    assert PIX <= THREADS         # a setup thread a pixel
    visits = _walk(P, PIX)
    # every (pixel, piece) of the tile once, thread t at flat index t +
    # 256 k, so a warp's pieces are consecutive
    flat = sorted(pix * P + piece for _, pix, piece in visits)
    assert flat == list(range(PIX * P))
    for tid, pix, piece in visits:
        assert (pix * P + piece - tid) % THREADS == 0


def _written(Ho, Wo, C, elem, src_addr, out_addr):
    """Element indices of one crop's output that the kernel writes (with
    repeats, if any); the vector route's stores are checked to lie on
    16-byte boundaries."""
    V, (TX, TY) = _route(C, elem, src_addr, out_addr)
    tiles_x, tiles_y = -(-Wo // TX), -(-Ho // TY)
    t = torch.arange(tiles_x * tiles_y)
    i = torch.arange(TX * TY)
    y = (t // tiles_x)[:, None] * TY + i // TX
    x = (t % tiles_x)[:, None] * TX + i % TX
    first = ((y * Wo + x) * C)[(y < Ho) & (x < Wo)]
    pieces = torch.arange(C // V) * V
    if V > 1:
        assert bool(((out_addr + (first[:, None] + pieces[None, :]) * elem)
                     % 16 == 0).all())
    return (first[:, None, None] + pieces[None, :, None]
            + torch.arange(V)[None, None, :]).reshape(-1)


@pytest.mark.parametrize("size", [37, 90, 96, 192])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("C", [1, 3, 5, 9, 12, 384])
@pytest.mark.parametrize("addr", [0, 4])
def test_every_output_element_is_written_once(size, elem, C, addr):
    """addr: the source and output pointers' offset from a 16-byte
    boundary (bf16 at 384 channels: 2 bytes)."""
    if elem == 2 and C == 384 and addr:
        addr = 2
    written = _written(size, size, C, elem, addr, addr)
    count = torch.bincount(written, minlength=size * size * C)
    assert count.numel() == size * size * C and bool((count == 1).all())


def test_the_bev_and_agent_shapes_take_the_routes_they_are_built_for():
    """The BEV trainer's 9 channels take the narrow route; the agent's 384
    f32 / bf16 channels the vector route; a source or output off a
    16-byte boundary sends them to the narrow route."""
    assert _route(9, 4, 0, 0) == (1, NARROW)
    assert _route(384, 4, 0, 0) == (4, VECTOR)
    assert _route(384, 2, 0, 0) == (8, VECTOR)
    assert _route(384, 4, 4, 0)[0] == _route(384, 2, 0, 2)[0] == 1


def _agent_grid(deg, loc=(3.0, -2.0), crop=96, out=96, H=160):
    theta = warp.crop_theta(torch.tensor([loc]),
                            torch.tensor([math.radians(deg)]), H, H, 2.0,
                            crop, 0.0, 0.75)
    return warp.affine_grid(theta, out, out)[0]


def _taps(grid, H, W, C):
    """Each pixel's top-left tap (a source element), as pixel_setup clamps
    its origin (fmax / fmin: a NaN position clamps to 0)."""
    ix = (grid[..., 0].float() + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1].float() + 1.0) * 0.5 * (H - 1)
    zero = torch.zeros((), dtype=torch.float32)
    x0 = torch.fmin(torch.fmax(torch.floor(ix), zero), zero + (W - 2))
    y0 = torch.fmin(torch.fmax(torch.floor(iy), zero), zero + (H - 2))
    return (y0.long() * W + x0.long()) * C


@pytest.mark.parametrize("C", [1, 9, 384])
def test_every_tap_lies_in_the_source(C):
    """A piece reads tap + piece * V, one pixel right, one row below and
    both; the last piece's last element must lie in the source."""
    H, W = 160, 150
    grids = [_agent_grid(deg, loc, crop, H=H)
             for deg in (0.0, 22.5, 45.0, 90.0, 135.0)
             for loc, crop in (((3.0, -2.0), 96), ((38.0, -39.0), 96),
                               ((1e3, -1e3), 96), ((0.0, 0.0), 192))]
    odd = torch.tensor([1e30, -1e30, float("inf"), -float("inf"),
                        float("nan"), 0.0])
    grids.append(torch.stack(torch.meshgrid(odd, odd, indexing="ij"), -1))
    for grid in grids:
        t = _taps(grid, H, W, C)
        assert bool((t >= 0).all())
        assert bool((t + (W + 1) * C + C - 1 < H * W * C).all())
    # a crop wholly outside reads one corner
    assert _taps(_agent_grid(33.0, (1e3, -1e3), H=H), H, W,
                 C).unique().numel() == 1
