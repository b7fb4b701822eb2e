"""The gradient of the point pillar's eval routes against lav_tpu's, on
the CPU.

* lav_tpu's production eval canvas is the zero-init drop scatter
  `jnp.zeros((S, C)).at[pid].max(feat, mode="drop")`
  (`lav_tpu/ops/pillar.py:482-487`), which JAX differentiates: its VJP
  splits a cell's gradient among the points that tie for its max and
  counts the zero operand as one more tie where the max is 0, each count
  a sum of ones in the feature dtype (so it stops at 256 in bf16), and
  multiplies g by 0 at the points that do not tie.  The port's
  `scatter_max_bwd_plain` (the plain version of kernel `scatter_max_bwd`)
  and its form on the forward's sort (through `ScatterMax`) are held to
  `jax.vjp` exactly, f32 and bf16, on rows of 1-300 tied points at 0 and
  at a positive value, all-zero cells, -0.0, dropped ids, a NaN feature
  and a NaN or inf gradient.
* `PointPillar` in eval mode on the production route: the point MLP's
  weight, bias and BN gradients against `jax.vjp` of lav_tpu's
  `point_pillar_apply(train=False, use_pallas=False)` with the converted
  params.  f32 within atol 1e-5 + rtol 1e-5 (the f32 decoration sums and
  the linear's products in another order); bf16 within 10% of each
  leaf's norm in L2, as the train route's bf16 test holds it (the bf16
  point MLPs round at other places).
* The use_pallas=True eval route cannot be differentiated in lav_tpu
  (`jax.grad` through `pillar_scatter_max_pallas` fails); the port's
  forward runs with parameters that require grad, and its backward
  raises.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.ops import pillar as JP
from lav_tpu_torch.ops import pillar as TP
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close

BF = jnp.bfloat16
PILLAR_F32_TOL = 1e-5
PILLAR_BF16_L2 = 1e-1
SIZES = (1, 2, 3, 255, 256, 257, 300)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tie_case(size, seed):
    """Row 0 holds `size` points tied at 0 in channel 0 (post-ReLU zeros)
    and at 1.5 in channel 1; channel 2 random positive, channel 3 -0.0 and
    negative values (a max of 0 that one -0.0 ties).  Rows 1-3 take a few
    random points each, row 4 only zeros (an all-zero cell), row 5 a NaN
    lane; 6 points are dropped (ids S and past it, as lav_tpu's route
    drops its invalid points; JAX would wrap a negative id), each above
    every other value; rows 6-7 are empty."""
    r = np.random.default_rng(seed)
    S, C = 8, 4
    pid = np.concatenate([np.zeros(size), r.integers(1, 4, 12),
                          np.full(3, 4), np.full(2, 5),
                          [S, S, S, S + 1, S + 2, 2 * S]])
    N = pid.size
    feat = r.uniform(0.1, 2.0, (N, C)).astype(np.float32)
    feat[:size, 0] = 0.0
    feat[:size, 1] = 1.5
    feat[:, 3] = -r.uniform(0.1, 2.0, N)
    feat[size + 3, 3] = -0.0
    feat[pid == 4] = 0.0
    feat[pid == 5, 2] = np.nan
    feat[-6:] = 9.0
    return feat, pid.astype(np.int32), S


def _jax_vjp(feat, pid, S, g, dt):
    def canvas(f):   # lav_tpu ops/pillar.py:482-487
        return jnp.zeros((S, f.shape[1]), dt).at[jnp.asarray(pid)].max(
            f, mode="drop")

    ref, vjp = jax.vjp(canvas, jnp.asarray(feat).astype(dt))
    (d,) = vjp(jnp.asarray(g).astype(dt))
    assert d.dtype == dt
    return np.asarray(ref.astype(jnp.float32)), np.asarray(
        d.astype(jnp.float32))


def _port(x, dtype):
    return _t(x).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", SIZES)
def test_zero_init_canvas_backward_matches_jax_vjp(size, dtype):
    feat, pid, S = _tie_case(size, 30 + size)
    jdt, tdt = (BF, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    # both sides hold the same dtype values: round through jax's bf16
    feat = np.asarray(jnp.asarray(feat).astype(jdt).astype(jnp.float32))
    g = np.random.default_rng(size).normal(size=(S, feat.shape[1]))
    g = np.asarray(jnp.asarray(g).astype(jdt).astype(jnp.float32))
    ref, d_ref = _jax_vjp(feat, pid, S, g, jdt)
    tf, tg, tp = _port(feat, tdt), _port(g, tdt), _t(pid)
    plain = TP.scatter_max_bwd_plain(tg, tf, tp, _port(ref, tdt))
    assert plain.dtype == tdt
    assert_close("eval_grad.zero_canvas_bwd_plain", plain.float(), d_ref,
                 atol=0)
    f = tf.clone().requires_grad_(True)
    out = TP.ScatterMax.apply(f, tp, S)      # on the forward's sort
    out.backward(tg)
    assert_close("eval_grad.zero_canvas", out.detach().float(), ref, atol=0)
    assert_close("eval_grad.zero_canvas_bwd_sorted", f.grad.float(), d_ref,
                 atol=0)
    # row 0, channel 0: the zero operand is one more tie, 256 at most in
    # bf16 (1/301 in f32, 1/256 in bf16 at 300 ties)
    n = size + 1 if dtype == "float32" else min(size + 1, 256)
    want = (tg[0, 0].float() * torch.tensor(1 / n).to(tdt).float()).to(tdt)
    assert torch.equal(plain[:size, 0], want.expand(size))
    assert float(plain[-6:].abs().max()) == 0.0
    # negative ids are dropped too (JAX would wrap them)
    tp[-3:] = -1
    assert torch.equal(TP.scatter_max_bwd_plain(tg, tf, tp, out.detach()),
                       plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_init_canvas_backward_takes_nan_and_inf_as_jax(dtype):
    """A NaN or inf in g: JAX multiplies g by the 0 coefficient of the
    points that do not tie, so the whole row turns NaN; a dropped point
    stays 0."""
    feat, pid, S = _tie_case(3, 5)
    jdt, tdt = (BF, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    feat = np.asarray(jnp.asarray(feat).astype(jdt).astype(jnp.float32))
    g = np.random.default_rng(1).normal(size=(S, feat.shape[1]))
    g[0, 0], g[1, 2], g[2, 1] = np.nan, np.inf, -np.inf
    g = np.asarray(jnp.asarray(g).astype(jdt).astype(jnp.float32))
    ref, d_ref = _jax_vjp(feat, pid, S, g, jdt)
    assert np.isnan(d_ref).any()
    plain = TP.scatter_max_bwd_plain(_port(g, tdt), _port(feat, tdt),
                                     _t(pid), _port(ref, tdt))
    assert_close("eval_grad.zero_canvas_bwd_nan", plain.float(), d_ref,
                 atol=0)
    assert float(plain[-6:].abs().max()) == 0.0


def test_zero_init_backward_routes_by_device():
    """The CPU takes the plain version, on the forward's sort when one is
    given (the same function); the sort is the one read_canvas_sort
    reads."""
    feat, pid, S = _tie_case(40, 2)
    tf, tp = _t(feat), _t(pid)
    canvas, sort = TP.scatter_max(tf, tp, S, keep_sort=True)
    torch.testing.assert_close(canvas, TP.scatter_max_plain(tf, tp, S),
                               rtol=0, atol=0, equal_nan=True)
    offsets, idx = TP.read_canvas_sort(sort, *feat.shape, S, 4)
    ok = (pid >= 0) & (pid < S)
    assert offsets[-1] == ok.sum() and torch.equal(
        tp[idx].long(), torch.repeat_interleave(torch.arange(S),
                                                offsets.diff()))
    g = torch.randn((S, feat.shape[1]), generator=torch.Generator()
                    .manual_seed(0))
    direct = TP.scatter_max_bwd(g, tf, tp, canvas)
    sorted_ = TP.scatter_max_bwd(g, tf, tp, canvas, sort)
    torch.testing.assert_close(direct, sorted_, rtol=0, atol=0,
                               equal_nan=True)
    # the NEG-init form on the same canvas counts no zero operand
    other = TP.pillar_scatter_max_bwd(g, tf, tp, canvas, sort)
    assert float((direct[:40, 0] - other[:40, 0]).abs().max()) > 0


def _pillar_case(dtype):
    cfg = tiny_config()
    geo = dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
               max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)
    params = JP.point_pillar_init(jax.random.key(3), cfg.num_input,
                                  cfg.num_features)
    r = np.random.default_rng(6)
    for i, c in enumerate(cfg.num_features):   # eval BN, not the identity
        params[f"bn_{i}"] = {
            "scale": jnp.asarray(r.uniform(0.5, 2, c), jnp.float32),
            "bias": jnp.asarray(r.normal(size=c), jnp.float32),
            "mean": jnp.asarray(r.normal(size=c), jnp.float32),
            "var": jnp.asarray(r.uniform(0.5, 2, c), jnp.float32)}
    B, P = 2, 128
    pts = r.uniform(-6, 14, (B, P, cfg.num_input - 5)).astype(np.float32)
    pts[0, 1] = pts[0, 0]                   # a duplicate point: ties
    pts[0, 2] = pts[0, 0]
    valid = r.uniform(size=(B, P)) > 0.1
    if dtype == "bfloat16":
        pts = np.asarray(jnp.asarray(pts).astype(BF).astype(jnp.float32))
    return cfg, geo, params, pts, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_pillar_eval_gradient_matches_jax(dtype):
    cfg, geo, params, pts, valid = _pillar_case(dtype)
    jdt, tdt = (BF, torch.bfloat16) if dtype == "bfloat16" else (
        jnp.float32, torch.float32)
    jpts = jnp.asarray(pts).astype(jdt)

    def f(pp):
        return JP.point_pillar_apply(pp, jpts, jnp.asarray(valid),
                                     num_features=cfg.num_features,
                                     train=False, use_pallas=False, **geo)[0]

    canvas, vjp = jax.vjp(f, params)
    C = cfg.num_features[-1]
    g = np.random.default_rng(2).normal(size=canvas.shape)
    g[..., C:] = 0.0                       # lav_tpu's padded lanes
    g = np.asarray(jnp.asarray(g).astype(jdt).astype(jnp.float32))
    (d_p,) = vjp(jnp.asarray(g).astype(jdt))
    pp = TP.PointPillar(cfg.num_input, cfg.num_features, **geo)
    load_jax_params(pp, jax.tree.map(np.asarray, params))
    assert not pp.training
    out = pp(_t(pts).to(tdt), _t(valid))
    assert out.dtype == tdt
    out.backward(_t(g[..., :C]).to(tdt))
    got = {}
    for i in range(len(cfg.num_features)):
        lin, bn = getattr(pp, f"linear_{i}"), getattr(pp, f"bn_{i}")
        got[f"linear_{i}.w"] = (lin.w.grad.T, d_p[f"linear_{i}"]["w"])
        got[f"linear_{i}.b"] = (lin.b.grad, d_p[f"linear_{i}"]["b"])
        got[f"bn_{i}.scale"] = (bn.scale.grad, d_p[f"bn_{i}"]["scale"])
        got[f"bn_{i}.bias"] = (bn.bias.grad, d_p[f"bn_{i}"]["bias"])
    for name, (a, b) in got.items():
        b = _t(np.asarray(b, np.float32))[:a.shape[0]] if a.dim() == 1 \
            else _t(np.asarray(b, np.float32))[:a.shape[0], :a.shape[1]]
        assert a.dtype == torch.float32 and float(b.norm()) > 0, name
        if dtype == "float32":
            assert_close(f"eval_grad.pillar.{name}", a, b,
                         atol=PILLAR_F32_TOL, rtol=PILLAR_F32_TOL)
        else:
            rel = float((a - b).norm() / b.norm())
            assert rel <= PILLAR_BF16_L2, (name, rel)


def test_use_pallas_eval_route_has_no_gradient():
    """lav_tpu cannot differentiate this route; the port's forward runs
    with parameters that require grad, and its backward raises, naming
    the route."""
    cfg, geo, params, pts, valid = _pillar_case("float32")
    pp = TP.PointPillar(cfg.num_input, cfg.num_features, **geo)
    load_jax_params(pp, jax.tree.map(np.asarray, params))
    out = pp(_t(pts), _t(valid), use_pallas=True)
    with torch.no_grad():
        ref = pp(_t(pts), _t(valid), use_pallas=True)
    assert out.requires_grad and torch.equal(out.detach(), ref)
    with pytest.raises(RuntimeError, match="use_pallas=True eval route"):
        out.sum().backward()
