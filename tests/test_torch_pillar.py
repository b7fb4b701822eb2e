"""lav_tpu_torch.ops.pillar against lav_tpu.ops.pillar on the CPU.

The plain version of kernel `pillar_scatter_max` against the Pallas
kernel `pillar_scatter_max_pallas(..., interpret=True)`: exact, since max
does not depend on order.  The port's featurizer (`use_pallas=True`
semantics) against JAX `point_pillar_apply(use_pallas=False)`, the form
that runs on the CPU; both give the zero canvas with per-pillar maxima,
JAX's emitted 128 lanes wide (lanes past C are zero).  f32, atol 1e-5
and rtol 1e-6 (the cluster means sum in another order; v2-range
coordinates give features near 50, where one f32 ulp is 4e-6).  The CUDA
kernel itself runs only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config, v2_config
from lav_tpu.ops import pillar as JP
from lav_tpu.ops.pillar_pallas import NEG, pillar_scatter_max_pallas
from lav_tpu_torch.ops import pillar as P
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scatter_case(seed, n, C, G, invalid_frac, negative_only=False):
    r = np.random.default_rng(seed)
    feat = r.normal(size=(n, C)).astype(np.float32)
    if negative_only:
        feat = -np.abs(feat) - 0.5
    pid = r.integers(0, max(G // 3, 1), size=(n,)).astype(np.int32)
    inv = r.uniform(size=n) < invalid_frac
    feat[inv] = NEG
    pid[inv] = G - 1          # the dump slot
    return feat, pid


@pytest.mark.parametrize("seed,n,C,G,invalid,neg", [
    (0, 512, 64, 200, 0.2, False),
    (1, 300, 32, 97, 0.5, True),     # negative maxima must survive
    (2, 100, 32, 64, 1.0, False),    # every point masked: all zeros
    (3, 1000, 8, 50, 0.0, False),    # many duplicates per pillar
])
def test_scatter_max_matches_pallas_interpret(seed, n, C, G, invalid, neg):
    feat, pid = _scatter_case(seed, n, C, G, invalid, neg)
    ref = pillar_scatter_max_pallas(jnp.asarray(feat), jnp.asarray(pid),
                                    num_segments=G, slab=128, interpret=True)
    out = P.pillar_scatter_max(torch.from_numpy(feat), torch.from_numpy(pid),
                               G)
    assert_close("pillar.scatter_max", out, ref, atol=0.0)
    if neg:
        assert (out.numpy() < 0).any()


def test_scatter_max_wrapper_routes_by_device():
    feat, pid = _scatter_case(4, 64, 16, 40, 0.3)
    f, p = torch.from_numpy(feat), torch.from_numpy(pid)
    assert torch.equal(P.pillar_scatter_max(f, p, 40),
                       P.pillar_scatter_max_plain(f, p, 40))
    with pytest.raises(ValueError):
        P.pillar_scatter_max(f.to("meta"), p.to("meta"), 40)


def _geo(cfg):
    return dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
                max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)


def _points(seed, B, n, D, lo=-6.0, hi=14.0, invalid_frac=0.1):
    r = np.random.default_rng(seed)
    pts = r.uniform(lo, hi, size=(B, n, D)).astype(np.float32)
    valid = r.uniform(size=(B, n)) > invalid_frac
    return pts, valid


def test_pillar_ids_and_decoration_match():
    cfg = tiny_config()
    geo = dict(_geo(cfg), nx=cfg.nx, ny=cfg.ny)
    pts, valid = _points(5, 2, 96, 8)
    pts[0, 0, 0] = 1e30          # a huge coordinate stays well defined
    jp = JP.compute_pillar_ids(jnp.asarray(pts), jnp.asarray(valid), **geo)
    tp = P.compute_pillar_ids(torch.from_numpy(pts), torch.from_numpy(valid),
                              **geo)
    for name, a, b in zip(("pid", "keep"), tp[:2], jp[:2]):
        assert_close(f"pillar.compute_pillar_ids.{name}", a.int(), b,
                     atol=0.0)
    keep = np.array(jp[1])
    for a, b in zip(tp[2:], jp[2:]):   # ix, iy agree wherever they count
        np.testing.assert_array_equal(a.numpy()[keep], np.asarray(b)[keep])

    S = cfg.nx * cfg.ny + 1
    offs = np.arange(2)[:, None] * S
    flat = lambda a: np.array(a).reshape(-1)
    pid = flat(np.asarray(jp[0]) + offs)
    ref = JP.decorate_points(
        jnp.asarray(pts.reshape(-1, 8)), jnp.asarray(pid), jp[1].reshape(-1),
        jp[2].reshape(-1), jp[3].reshape(-1), min_x=cfg.min_x,
        min_y=cfg.min_y, pixels_per_meter=cfg.pixels_per_meter, nx=cfg.nx,
        ny=cfg.ny, num_segments=2 * S)
    out = P.decorate_points(
        torch.from_numpy(pts.reshape(-1, 8)), torch.from_numpy(pid),
        torch.from_numpy(keep.reshape(-1)),
        torch.from_numpy(flat(jp[2])), torch.from_numpy(flat(jp[3])),
        min_x=cfg.min_x, min_y=cfg.min_y,
        pixels_per_meter=cfg.pixels_per_meter, num_segments=2 * S)
    k = keep.reshape(-1)
    assert_close("pillar.decorate_points", out.numpy()[k],
                 np.asarray(ref)[k], atol=1e-5)


@pytest.mark.parametrize("cfg_name,B,n", [("tiny", 2, 128), ("v2", 1, 512)])
def test_point_pillar_matches_jax(cfg_name, B, n):
    cfg = tiny_config() if cfg_name == "tiny" else v2_config()
    params = JP.point_pillar_init(jax.random.key(3), cfg.num_input,
                                  cfg.num_features)
    # non-trivial eval statistics, so BN is not the identity
    r = np.random.default_rng(6)
    for i, c in enumerate(cfg.num_features):
        params[f"bn_{i}"] = {
            "scale": jnp.asarray(r.uniform(0.5, 2, c), jnp.float32),
            "bias": jnp.asarray(r.normal(size=c), jnp.float32),
            "mean": jnp.asarray(r.normal(size=c), jnp.float32),
            "var": jnp.asarray(r.uniform(0.5, 2, c), jnp.float32)}
    D = cfg.num_input - 5
    lo, hi = cfg.min_x - 5, cfg.max_x + 5
    pts, valid = _points(7, B, n, D, lo, hi)
    ref, _ = JP.point_pillar_apply(
        params, jnp.asarray(pts), jnp.asarray(valid), **_geo(cfg),
        num_features=cfg.num_features, train=False, use_pallas=False)
    model = P.PointPillar(cfg.num_input, cfg.num_features, **_geo(cfg))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        out = model(torch.from_numpy(pts), torch.from_numpy(valid))
    C = cfg.num_features[-1]
    ref = np.asarray(ref)
    assert out.shape == (B, cfg.ny, cfg.nx, C)
    assert (ref[..., C:] == 0).all()
    assert_close("pillar.point_pillar_apply", out, ref[..., :C], atol=1e-5,
                 rtol=1e-6)
    assert (out.numpy() == 0).all(axis=-1).mean() > 0.5  # empty pillars
