"""lav_tpu_torch.core.warp against lav_tpu.core.warp on the CPU.

The port's `crop_feature_shared` (kernel `crop_shared`, which on CPU
tensors runs its plain version) against JAX `crop_feature_shared(...,
use_pallas=True, pallas_interpret=True)`, which runs the Pallas crop
kernel in interpret mode.  Shapes follow tests/test_warp_pallas.py, plus
crops that straddle the border and crops wholly outside the source.

Tolerances (f32): on one shared sampling grid the port's sampler agrees
with lav_tpu's XLA gather at atol 1e-6, and with the Pallas kernel at
atol 1e-5 / rtol 1e-5, the tolerance tests/test_warp_pallas.py holds the
Pallas kernel to against the XLA gather.  Through `crop_feature_shared` each side
builds its own grid, and jnp.linspace and torch.linspace differ by one f32
ulp (1.2e-7 of the [-1, 1] range, ~2e-6 px), which moves a bilinear value
by up to ~3e-5 on these unit-variance maps; those checks use atol 5e-5
(lav_tpu's own Pallas and XLA routes differ by 1.1e-5 on the same inputs).
The q8 form (int8 crops, kernel `crop_shared_q8`) against the Pallas q8
kernel in interpret mode on lav_tpu's grid, bf16 source: both quantize the
f32 bilinear sum, which the two sum in another order, so a value on a
rounding boundary may land one step apart: at most 1 step, on at most 1%
of the values.  The space-to-depth q8 crops (kernel `crop_shared_q8_s2d`,
lav_tpu's `LAV_S2D_CROPS=1`) through `crop_feature_shared` against
lav_tpu's `crop_feature_shared(..., q8_s2d=True)`, on its Pallas route in
interpret mode (bf16 source; the kernel's own s2d emit) and on its XLA
route (f32 source: that route quantizes the crop after casting it to the
source dtype, which in bf16 would move ~0.25 step), at the same
tolerance.  The CUDA kernels themselves run only on the card
(chip_smoke.py).

The tiled int8 kernel's addressing (`_tile_offsets`, a pure-Python
statement of where kernel `crop_shared_q8` reads and writes over 16-byte
source vectors; tile size, threads and pieces read from
csrc/crop_shared.cu): its threads' (pixel, channel piece) pairs cover each
tile once, the tiles write every output element exactly once (96x96,
90x90 with partial tiles, 37x37; bf16 and f32 pieces; the s2d layout
equal to `space_to_depth`'s), and all four taps of every pixel lie in the
source for rotations 0-90 degrees, a crop wholly outside, a zoom-out crop
and grids of +-1e30, +-inf and NaN.
"""

import math
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.core.warp import (
    _crop_theta, affine_grid as j_affine_grid, crop_feature_shared as j_crop,
    grid_sample_shared as j_grid_sample_shared,
)
from lav_tpu.core.warp_pallas import (
    grid_sample_shared_pallas, grid_sample_shared_pallas_q8, s2d_eligible,
)
from lav_tpu_torch.core import warp
from lav_tpu_torch.utils import native
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _crop_inputs(seed, K, H, C, scale, edge=False, far=False, ppm=2.0):
    r = np.random.default_rng(seed)
    feats = r.normal(size=(H, H, C)).astype(np.float32)
    locs = r.uniform(-scale, scale, (K, 2)).astype(np.float32)
    oris = r.uniform(-np.pi, np.pi, (K,)).astype(np.float32)
    if edge:   # centre near the border: part of the crop lies outside
        locs[0] = [0.9 * H / (2 * ppm), -0.95 * H / (2 * ppm)]
    if far:    # wholly outside the source
        locs[-1] = [500.0, -700.0]
    return feats, locs, oris


CASES = [
    # (seed, K, H, C, crop, ppm, scale, offset_y, edge, far)
    (3, 3, 40, 64, 24, 2.0, 2.0, 0.75, False, False),
    (4, 3, 40, 128, 24, 2.0, 8.0, 0.75, False, False),
    (5, 4, 32, 64, 16, 2.0, 3.0, 0.5, False, False),
    (6, 3, 40, 64, 24, 2.0, 2.0, 0.75, True, False),
    (7, 3, 40, 64, 24, 2.0, 2.0, 0.75, True, True),
    (8, 2, 48, 16, 16, 4.0, 2.0, 0.75, True, True),
]


@pytest.mark.parametrize("case", CASES)
def test_sampler_matches_pallas_kernel_on_one_grid(case):
    """The plain version of `crop_shared` against the Pallas kernel in
    interpret mode and against the XLA gather, all fed lav_tpu's own
    sampling grid."""
    seed, K, H, C, crop, ppm, scale, off_y, edge, far = case
    feats, locs, oris = _crop_inputs(seed, K, H, C, scale, edge, far, ppm)
    theta = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), H, H, ppm,
                        crop, 0.0, off_y)
    grid = j_affine_grid(theta, crop, crop)
    ref = grid_sample_shared_pallas(jnp.asarray(feats), grid, True)
    xla = j_grid_sample_shared(jnp.asarray(feats), grid)
    out = warp.crop_shared(torch.from_numpy(feats)[None],
                           torch.from_numpy(np.array(grid))[None])
    assert_close("warp.crop_shared_vs_pallas", out[0], ref, atol=1e-5,
                 rtol=1e-5)
    assert_close("warp.crop_shared_vs_xla", out[0], xla, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_crop_feature_shared_matches_pallas_interpret(case):
    seed, K, H, C, crop, ppm, scale, off_y, edge, far = case
    feats, locs, oris = _crop_inputs(seed, K, H, C, scale, edge, far, ppm)
    kw = dict(pixels_per_meter=ppm, crop_size=crop, offset_y=off_y)
    ref = j_crop(jnp.asarray(feats), jnp.asarray(locs), jnp.asarray(oris),
                 use_pallas=True, pallas_interpret=True, **kw)
    out = warp.crop_feature_shared(torch.from_numpy(feats),
                                   torch.from_numpy(locs),
                                   torch.from_numpy(oris), **kw)
    assert_close("warp.crop_feature_shared", out, ref, atol=5e-5)
    if far:
        assert float(out[-1].abs().max()) == 0.0
    if edge:   # the straddling crop keeps partial, nonzero border weights
        assert 0.0 < float((out[0] == 0).float().mean()) < 1.0


def test_batched_crops_match_per_item():
    """Each ego crops its own source: the batched call equals per-item
    JAX crops."""
    E, K, H, C, crop = 3, 4, 32, 16, 16
    items = [_crop_inputs(20 + e, K, H, C, 4.0, edge=e == 1, far=e == 2)
             for e in range(E)]
    kw = dict(pixels_per_meter=2.0, crop_size=crop, offset_y=0.75)
    out = warp.crop_feature_shared(
        torch.from_numpy(np.stack([f for f, _, _ in items])),
        torch.from_numpy(np.stack([l for _, l, _ in items])),
        torch.from_numpy(np.stack([o for _, _, o in items])), **kw)
    assert out.shape == (E, K, crop, crop, C)
    for e, (f, l, o) in enumerate(items):
        ref = j_crop(jnp.asarray(f), jnp.asarray(l), jnp.asarray(o),
                     use_pallas=True, pallas_interpret=True, **kw)
        assert_close("warp.crop_feature_shared", out[e], ref, atol=5e-5)


def test_grid_and_theta_match():
    feats, locs, oris = _crop_inputs(9, 5, 40, 4, 6.0)
    theta_j = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), 40, 40, 2.0,
                          24, 0.0, 0.75)
    theta_t = warp.crop_theta(torch.from_numpy(locs), torch.from_numpy(oris),
                              40, 40, 2.0, 24, 0.0, 0.75)
    assert_close("warp.crop_theta", theta_t, theta_j, atol=1e-6)
    assert_close("warp.affine_grid", warp.affine_grid(theta_t, 24, 24),
                 j_affine_grid(theta_j, 24, 24), atol=1e-6)


def test_plain_bf16_matches_jax_gather():
    """The plain version in bf16 (weights cast to bf16, f32 sums, one
    rounding at the end) against lav_tpu's XLA gather form in bf16: at
    most one bf16 ulp apart where the two sums round differently."""
    feats, locs, oris = _crop_inputs(10, 3, 40, 32, 4.0, edge=True)
    theta = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), 40, 40, 2.0,
                        24, 0.0, 0.75)
    grid = np.array(j_affine_grid(theta, 24, 24))
    src = jnp.asarray(feats, jnp.bfloat16)
    ref = np.asarray(j_grid_sample_shared(src, jnp.asarray(grid)),
                     np.float32)
    out = warp.grid_sample_shared(
        torch.from_numpy(feats).bfloat16()[None], torch.from_numpy(grid)[None])
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    diff = np.abs(out[0].float().numpy() - ref)
    assert (diff <= ulp + 1e-30).all()
    assert_close("warp.grid_sample_shared_bf16", out[0], ref,
                 atol=float(ulp.max()))


def test_wrapper_routes_by_device():
    """CPU tensors take the plain version; a tensor on a device that is
    neither CPU nor CUDA is refused, never moved."""
    feats, locs, oris = _crop_inputs(11, 2, 32, 8, 3.0)
    theta = warp.crop_theta(torch.from_numpy(locs), torch.from_numpy(oris),
                            32, 32, 2.0, 16, 0.0, 0.75)
    grid = warp.affine_grid(theta, 16, 16)[None].contiguous()
    src = torch.from_numpy(feats)[None]
    assert torch.equal(warp.crop_shared(src, grid),
                       warp.grid_sample_shared(src, grid))
    with pytest.raises(ValueError):
        warp.crop_shared(src.to("meta"), grid.to("meta"))


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_q8_crop_matches_pallas_q8_kernel(case):
    seed, K, H, C, crop, ppm, scale, off_y, edge, far = case
    feats, locs, oris = _crop_inputs(seed, K, H, C, scale, edge, far, ppm)
    src = jnp.asarray(feats, jnp.bfloat16)
    x_scale = np.float32(float(jnp.abs(src.astype(jnp.float32)).max())
                         / 127.0)
    theta = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), H, H, ppm,
                        crop, 0.0, off_y)
    grid = j_affine_grid(theta, crop, crop)
    ref = np.asarray(grid_sample_shared_pallas_q8(
        src, grid, jnp.float32(x_scale), interpret=True))
    out = warp.crop_shared(torch.from_numpy(feats).bfloat16()[None],
                           torch.from_numpy(np.array(grid))[None],
                           q8_x_scale=torch.tensor(x_scale))
    assert out.dtype == torch.int8 and ref.dtype == np.int8
    diff = np.abs(out[0].numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (
        diff.max(), (diff > 0).mean())
    assert_close("warp.crop_shared_q8", out[0], ref, atol=1.0)
    assert np.abs(ref).max() > 64          # the int8 range is used
    if far:
        assert int(out[0, -1].abs().max()) == 0


S2D_CASES = [
    # (seed, K, H, C, crop, ppm, scale, offset_y, edge, far)
    CASES[2],
    (12, 3, 64, 32, 32, 2.0, 4.0, 0.75, True, True),
]


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("case", S2D_CASES)
def test_s2d_q8_crops_match_lav_tpu(case, route):
    seed, K, H, C, crop, ppm, scale, off_y, edge, far = case
    feats, locs, oris = _crop_inputs(seed, K, H, C, scale, edge, far, ppm)
    dtype = jnp.bfloat16 if route == "pallas" else jnp.float32
    src = jnp.asarray(feats, dtype)
    x_scale = np.float32(float(jnp.abs(src.astype(jnp.float32)).max())
                         / 127.0)
    kw = dict(pixels_per_meter=ppm, crop_size=crop, offset_y=off_y)
    if route == "pallas":   # lav_tpu's kernel emits the s2d layout itself
        assert s2d_eligible(feats.shape, (crop, crop), 2)
    ref = np.asarray(j_crop(src, jnp.asarray(locs), jnp.asarray(oris),
                            use_pallas=route == "pallas",
                            pallas_interpret=True, q8_x_scale=x_scale,
                            q8_s2d=True, **kw))
    tsrc = torch.from_numpy(np.array(src.astype(jnp.float32)))
    if route == "pallas":
        tsrc = tsrc.bfloat16()
    out = warp.crop_feature_shared(tsrc, torch.from_numpy(locs),
                                   torch.from_numpy(oris),
                                   q8_x_scale=torch.tensor(x_scale), s2d=True,
                                   **kw)
    assert out.dtype == torch.int8 and ref.dtype == np.int8
    assert out.shape == ref.shape == (K, crop // 2, crop // 2, 4 * C)
    diff = np.abs(out.numpy().astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (
        diff.max(), (diff > 0).mean())
    assert_close("warp.crop_shared_q8_s2d", out, ref, atol=1.0)
    assert np.abs(ref).max() > 64
    # the same crops as the q8 form, reshuffled
    q8 = warp.crop_feature_shared(tsrc, torch.from_numpy(locs),
                                  torch.from_numpy(oris),
                                  q8_x_scale=torch.tensor(x_scale), **kw)
    assert torch.equal(out, warp.space_to_depth(q8[None])[0])
    if far:
        assert int(out[-1].abs().max()) == 0


def test_s2d_wrapper_routes_and_refuses():
    """s2d needs q8 and an even crop; a meta tensor is refused."""
    feats, locs, oris = _crop_inputs(13, 2, 32, 8, 3.0)
    theta = warp.crop_theta(torch.from_numpy(locs), torch.from_numpy(oris),
                            32, 32, 2.0, 16, 0.0, 0.75)
    grid = warp.affine_grid(theta, 16, 16)[None].contiguous()
    src = torch.from_numpy(feats)[None]
    s = torch.tensor(0.05)
    out = warp.crop_shared(src, grid, q8_x_scale=s, s2d=True)
    assert out.shape == (1, 2, 8, 8, 32)
    assert torch.equal(out, warp.space_to_depth(
        warp.grid_sample_shared_q8(src, grid, warp.inverse_scale(s))))
    with pytest.raises(ValueError):
        warp.crop_shared(src, grid, s2d=True)              # not q8
    with pytest.raises(ValueError):
        warp.crop_shared(src, grid[:, :, :15, :15].contiguous(),
                         q8_x_scale=s, s2d=True)           # odd crop
    with pytest.raises(ValueError):
        warp.crop_shared(src.to("meta"), grid.to("meta"),
                         q8_x_scale=s.to("meta"), s2d=True)


def _tile_offsets(grid, H, W, C, T, s2d=False):
    """Kernel `crop_shared_q8`'s tiled form (`crop_q8_tiled`, over 16-byte
    source vectors) as pure Python, for one crop: grid (Ho, Wo, 2) f32,
    source H x W x C -> (taps, outs), LongTensors (tiles, T*T) over the
    T x T tiles of output
    pixels in row-major order (the kernel's blockIdx.x) and their pixels in
    row-major order (the setup thread of each).  taps: each pixel's
    top-left tap as a source element, (y0 W + x0) C, with the origin
    clamped into [0, W-2] x [0, H-2] as the kernel clamps it (fmax / fmin:
    a NaN position clamps to 0); its other taps are C, W C and (W+1) C
    further.  outs: the pixel's first output element, in the (Ho/2, Wo/2,
    4C) layout with `s2d`; -1 for a tile's pixels past the crop."""
    Ho, Wo, _ = grid.shape
    ix = (grid[..., 0].float() + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1].float() + 1.0) * 0.5 * (H - 1)
    zero = torch.zeros((), dtype=torch.float32)
    x0 = torch.fmin(torch.fmax(torch.floor(ix), zero), zero + (W - 2))
    y0 = torch.fmin(torch.fmax(torch.floor(iy), zero), zero + (H - 2))
    tap = (y0.long() * W + x0.long()) * C
    y = torch.arange(Ho)[:, None].expand(Ho, Wo)
    x = torch.arange(Wo)[None, :].expand(Ho, Wo)
    if s2d:
        out = ((y // 2) * (Wo // 2) + x // 2) * 4 * C + ((y % 2) * 2
                                                          + x % 2) * C
    else:
        out = (y * Wo + x) * C
    ty, tx = -(-Ho // T), -(-Wo // T)
    taps = torch.zeros((ty * T, tx * T), dtype=torch.long)
    outs = torch.full((ty * T, tx * T), -1, dtype=torch.long)
    taps[:Ho, :Wo], outs[:Ho, :Wo] = tap, out
    def tiles(t):
        return t.reshape(ty, T, tx, T).permute(0, 2, 1, 3).reshape(
            ty * tx, T * T)
    return tiles(taps), tiles(outs)


def _kernel_constants():
    """kTile, kQThreads and kPieces as csrc/crop_shared.cu states them."""
    src = (native.CSRC_DIR / "crop_shared.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kTile", "kQThreads", "kPieces"))


def _agent_grid(deg, loc=(3.0, -2.0), crop=96, out=96, H=160):
    theta = warp.crop_theta(torch.tensor([loc]),
                            torch.tensor([math.radians(deg)]), H, H, 2.0,
                            crop, 0.0, 0.75)
    return warp.affine_grid(theta, out, out)[0]


@pytest.mark.parametrize("size,s2d", [(96, False), (96, True), (90, False),
                                      (90, True), (37, False)])
def test_tiled_kernel_writes_every_output_element_once(size, s2d):
    T, threads, pieces = _kernel_constants()
    slots = threads // pieces
    # a thread's pixels slot + slots i and pieces part + pieces ch: each
    # tile pixel and each V-channel piece once
    assert sorted(s_ + slots * i for s_ in range(slots)
                  for i in range(T * T // slots)) == list(range(T * T))
    H = W = 160
    grid = _agent_grid(30.0, out=size)
    for C, V in ((384, 8), (384, 4), (40, 8)):
        CC = pieces * V
        starts = [ch * CC + part * V for ch in range(-(-C // CC))
                  for part in range(pieces) if ch * CC + part * V < C]
        assert sorted(starts) == list(range(0, C, V))
        _, outs = _tile_offsets(grid, H, W, C, T, s2d)
        assert outs.shape == ((-(-size // T)) ** 2, T * T)
        first = outs[outs >= 0]
        assert first.numel() == size * size
        written = (first[:, None] + torch.arange(C)[None, :]).reshape(-1)
        count = torch.bincount(written, minlength=size * size * C)
        assert count.numel() == size * size * C and bool((count == 1).all())
        if s2d:   # the kernel's s2d store is space_to_depth's layout
            orig = torch.arange(size * size * C).reshape(1, 1, size, size, C)
            at = warp.space_to_depth(orig).reshape(-1)
            _, plain = _tile_offsets(grid, H, W, C, T, False)
            keep = plain >= 0
            assert torch.equal(at[outs[keep]], plain[keep])


def test_tiled_kernel_taps_stay_in_the_source():
    T = _kernel_constants()[0]
    H, W, C = 160, 150, 64
    grids = [_agent_grid(deg, loc, crop, H=H)
             for deg in (0.0, 22.5, 45.0, 67.5, 90.0)
             for loc, crop in (((3.0, -2.0), 96), ((38.0, -39.0), 96),
                               ((1e3, -1e3), 96), ((0.0, 0.0), 192))]
    odd = torch.tensor([1e30, -1e30, float("inf"), -float("inf"),
                        float("nan"), 0.0])
    grids.append(torch.stack(torch.meshgrid(odd, odd, indexing="ij"), -1))
    for grid in grids:
        taps, outs = _tile_offsets(grid, H, W, C, T)
        t = taps[outs >= 0]
        assert bool((t >= 0).all())
        assert bool((t + (W + 1) * C + C <= H * W * C).all())
    # a crop wholly outside reads one corner
    taps, outs = _tile_offsets(_agent_grid(33.0, (1e3, -1e3), H=H),
                                        H, W, C, T)
    assert taps[outs >= 0].unique().numel() == 1
