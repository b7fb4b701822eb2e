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
of the values.  The CUDA kernels themselves run only on the card
(chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.core.warp import (
    _crop_theta, affine_grid as j_affine_grid, crop_feature_shared as j_crop,
    grid_sample_shared as j_grid_sample_shared,
)
from lav_tpu.core.warp_pallas import (
    grid_sample_shared_pallas, grid_sample_shared_pallas_q8,
)
from lav_tpu_torch.core import warp
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
