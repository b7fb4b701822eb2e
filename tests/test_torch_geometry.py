"""The last lav_tpu functions the port copied, against lav_tpu on the CPU.

`core/geometry.py`'s `rotate_points_deg`, `rotate_lidar_deg` and
`latlon_to_xy`, `core/warp.py`'s `grid_sample` (one crop an item through
kernel `crop_shared`, whose plain version CPU tensors take) and
`models/losses.py`'s `plan_loss_at_cmd`, each held to its lav_tpu function
on the same numpy inputs made from a seed, at f32.

Tolerances: the geometry is the same f32 operations in the same order on
both sides, so the results agree to an f32 rounding of their magnitude
(rtol 1e-6; the coordinates are meters, the GNSS ones ~5e6).
`grid_sample` at atol 1e-6, the tolerance at which the port's sampler
(the hinge weights over a clamped tap origin) and lav_tpu's XLA gather
(zero-padded taps) agree on one grid (tests/test_torch_warp.py); its
image gradient, the crop's own backward against `jax.vjp` of lav_tpu's
sampler, at atol 1e-5 (a cell sums up to ~16 terms, in another order).
In bf16 lav_tpu rounds each product to bf16 and adds in bf16, while the
port adds in f32 and rounds once (ROADMAP §C, "does not copy"): at most
2 bf16 ulps of the image's largest magnitude apart.  The loss is a mean
of L1 terms, atol 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.core import geometry as jgeo
from lav_tpu.core.warp import grid_sample as j_grid_sample
from lav_tpu.models import losses as jlosses

from lav_tpu_torch.core import geometry, warp
from lav_tpu_torch.models import losses
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("angle", [37.5, -123.0, 0.0])
def test_rotate_points_deg_matches_lav_tpu(angle):
    r = np.random.default_rng(int(angle) + 200)
    pts = r.normal(scale=20.0, size=(3, 7, 2)).astype(np.float32)
    center = r.normal(scale=5.0, size=(2,)).astype(np.float32)
    ref = jgeo.rotate_points_deg(jnp.asarray(pts), angle, jnp.asarray(center))
    out = geometry.rotate_points_deg(_t(pts), angle, _t(center))
    assert out.dtype == torch.float32 and out.shape == pts.shape
    assert_close("geometry.rotate_points_deg", out, ref, atol=1e-5,
                 rtol=1e-6)


@pytest.mark.parametrize("angle", [23.0, -90.0])
def test_rotate_lidar_deg_matches_lav_tpu(angle):
    """R^T relative to transform_points, z and the return untouched."""
    r = np.random.default_rng(int(angle) + 300)
    lidar = r.normal(scale=30.0, size=(50, 4)).astype(np.float32)
    ref = jgeo.rotate_lidar_deg(jnp.asarray(lidar), angle)
    out = geometry.rotate_lidar_deg(_t(lidar), angle)
    assert out.shape == lidar.shape
    assert_close("geometry.rotate_lidar_deg", out, ref, atol=1e-5, rtol=1e-6)
    assert torch.equal(out[:, 2:], _t(lidar)[:, 2:])
    # +90 degrees takes (1, 0) to (0, 1): cos x - sin y, sin x + cos y
    one = geometry.rotate_lidar_deg(torch.tensor([[1.0, 0.0, 2.0, 0.5]]),
                                    90.0)
    assert torch.allclose(one, torch.tensor([[0.0, 1.0, 2.0, 0.5]]),
                          atol=1e-6)


def test_latlon_to_xy_matches_lav_tpu():
    r = np.random.default_rng(400)
    lat = (48.1 + r.normal(scale=1e-3, size=(9,))).astype(np.float32)
    lon = (11.5 + r.normal(scale=1e-3, size=(9,))).astype(np.float32)
    cos0 = np.float32(np.deg2rad(48.1))
    rx, ry = jgeo.latlon_to_xy(jnp.asarray(lat), jnp.asarray(lon),
                               jnp.asarray(cos0))
    x, y = geometry.latlon_to_xy(_t(lat), _t(lon), torch.tensor(cos0))
    assert geometry.EARTH_RADIUS == jgeo.EARTH_RADIUS
    assert_close("geometry.latlon_to_xy x", x, rx, atol=0.0, rtol=1e-6)
    assert_close("geometry.latlon_to_xy y", y, ry, atol=0.0, rtol=1e-6)
    # a Python float cos0, as lav_tpu's takes one
    x2, y2 = geometry.latlon_to_xy(_t(lat), _t(lon), float(cos0))
    assert torch.equal(x2, x) and torch.equal(y2, y)


def _sample_inputs(seed, B=2, H=13, W=17, C=5, Ho=6, Wo=9):
    r = np.random.default_rng(seed)
    img = r.normal(size=(B, H, W, C)).astype(np.float32)
    # a fifth of the points beyond [-1, 1], where taps fall outside
    grid = r.uniform(-1.25, 1.25, size=(B, Ho, Wo, 2)).astype(np.float32)
    return img, grid


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_sample_matches_lav_tpu(seed):
    img, grid = _sample_inputs(seed)
    ref = j_grid_sample(jnp.asarray(img), jnp.asarray(grid))
    out = warp.grid_sample(_t(img), _t(grid))
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert_close("warp.grid_sample", out, ref, atol=1e-6)
    # one crop an item of crop_shared
    assert torch.equal(out, warp.crop_shared(_t(img), _t(grid)[:, None])[:, 0])


def test_grid_sample_bf16_is_within_two_ulps_of_lav_tpu():
    img, grid = _sample_inputs(2)
    jimg = jnp.asarray(img, jnp.bfloat16)
    ref = np.asarray(j_grid_sample(jimg, jnp.asarray(grid)), np.float32)
    out = warp.grid_sample(torch.from_numpy(np.array(jimg.astype(
        jnp.float32))).bfloat16(), _t(grid))
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(img).max())) - 7)
    assert_close("warp.grid_sample_bf16", out, ref, atol=2 * ulp)


def test_grid_sample_image_gradient_matches_lav_tpu():
    img, grid = _sample_inputs(3)
    g = np.random.default_rng(5).normal(size=(2, 6, 9, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_grid_sample(a, jnp.asarray(grid)),
                     jnp.asarray(img))
    ref, = vjp(jnp.asarray(g))
    timg = _t(img).requires_grad_(True)
    out = warp.grid_sample(timg, _t(grid))
    out.backward(_t(g))
    assert_close("warp.grid_sample d_img", timg.grad, ref, atol=1e-5)


@pytest.mark.parametrize("img_grad", [False, True])
def test_grid_sample_refuses_a_grid_that_requires_grad(img_grad):
    """The sampler's gradient reaches the image only, on both devices: a
    grid that requires grad raises while grad mode is on, rather than give
    a grid gradient on the CPU and none on the card."""
    img, grid = _sample_inputs(4)
    timg = _t(img).requires_grad_(img_grad)
    tgrid = _t(grid).requires_grad_(True)
    with pytest.raises(ValueError, match="grid"):
        warp.grid_sample(timg, tgrid)


def test_grid_sample_takes_a_grid_that_requires_grad_under_no_grad():
    img, grid = _sample_inputs(4)
    want = warp.grid_sample(_t(img), _t(grid))
    with torch.no_grad():
        out = warp.grid_sample(_t(img), _t(grid).requires_grad_(True))
    assert torch.equal(out, want)


@pytest.mark.parametrize("per_iter,masked", [(False, False), (True, True),
                                             (False, True)])
def test_plan_loss_at_cmd_matches_lav_tpu(per_iter, masked):
    r = np.random.default_rng(500 + 2 * per_iter + masked)
    B, I, C, T = 4, 3, 6, 5
    plans = r.normal(size=(B, I, C, T, 2)).astype(np.float32)
    target = r.normal(size=(B, I, T, 2) if per_iter else (B, T, 2)).astype(
        np.float32)
    cmds = r.integers(0, C, size=(B,)).astype(np.int32)
    idxs = np.array([True, False, True, True]) if masked else None
    ref = jlosses.plan_loss_at_cmd(
        jnp.asarray(plans), jnp.asarray(target), jnp.asarray(cmds),
        None if idxs is None else jnp.asarray(idxs))
    out = losses.plan_loss_at_cmd(_t(plans), _t(target), _t(cmds),
                                  None if idxs is None else _t(idxs))
    assert out.shape == ()
    assert_close("losses.plan_loss_at_cmd", out, ref, atol=1e-6)
