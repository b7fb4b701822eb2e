"""The port's training pieces against lav_tpu's on the CPU: the two
gradients that have kernels, train-mode BatchNorm, the losses and the car
pick of the distillation step.

* The shared crop's source gradient (`warp.grid_sample_shared_bwd`, the
  plain version of kernel `crop_shared_bwd`, and the `CropShared` autograd
  through `crop_feature_shared`) against `jax.vjp` of lav_tpu's
  `grid_sample_shared` (its custom VJP `_grid_sample_shared_bwd`) and of
  `grid_sample_shared_pallas(..., interpret=True)`, on lav_tpu's grid.
  Both add four products per output pixel in f32 in another order; a
  source cell here gets at most a few dozen terms, so atol 1e-5 on
  unit-variance inputs.  The grid gets no gradient.
* `crop_feature` (one crop per item) with its gradient against lav_tpu's
  (`grid_sample`, differentiated by XLA): each side builds its own grid,
  and jnp.linspace and torch.linspace differ by an ulp (see
  tests/test_torch_warp.py), so atol 5e-5 on the crop and 1e-4 on the
  gradient.
* The training canvas max (`CanvasMax`, backward
  `pillar_scatter_max_bwd_plain`) against `jax.grad` of lav_tpu's train
  route (`ops/pillar.py:516-522`), with ties of 2 and 3 points, ties at
  0, invalid points (one above every valid value) and empty cells: exact,
  since both divide each cell's gradient by its tie count in f32.
* Train-mode `BatchNorm`, plain and masked, against `L.batchnorm(...,
  train=True)`: output, gradients and the updated running statistics, at
  atol 1e-5 (f32 sums in another order).
* The point pillar's train route against `point_pillar_apply(train=True)`
  (canvas, BN state, weight gradients), atol 1e-5 / rtol 1e-5.
* Each loss the distillation step uses, and `select_cars` with more
  non-qualifying (-inf) slots than cars, whose indices must be
  `lax.top_k`'s (ties to the lowest index).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.core.warp import (
    _crop_theta, affine_grid as j_affine_grid, crop_feature as j_crop_feature,
    grid_sample_shared as j_grid_sample_shared,
)
from lav_tpu.core.warp_pallas import grid_sample_shared_pallas
from lav_tpu.config import tiny_config
from lav_tpu.models import losses as JL
from lav_tpu.models.planner import select_cars as j_select_cars
from lav_tpu.nn import layers as JLay
from lav_tpu.ops import pillar as JP
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.core import warp
from lav_tpu_torch.models import losses as TL
from lav_tpu_torch.models.planner import select_cars
from lav_tpu_torch.nn.layers import BatchNorm
from lav_tpu_torch.ops import pillar as TP
from lav_tpu_torch.utils.tree import bn_state, merge_bn_state
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


CROP_CASES = [
    # (seed, K, H, C, crop, scale, edge, far)
    (3, 3, 40, 64, 24, 2.0, False, False),
    (6, 3, 40, 64, 24, 2.0, True, False),
    (7, 3, 40, 64, 24, 2.0, True, True),
]


@pytest.mark.parametrize("case", CROP_CASES)
def test_crop_backward_matches_jax_vjp(case):
    seed, K, H, C, crop, scale, edge, far = case
    r = np.random.default_rng(seed)
    feats = r.normal(size=(H, H, C)).astype(np.float32)
    locs = r.uniform(-scale, scale, (K, 2)).astype(np.float32)
    oris = r.uniform(-np.pi, np.pi, (K,)).astype(np.float32)
    if edge:
        locs[0] = [0.9 * H / 4, -0.95 * H / 4]
    if far:
        locs[-1] = [500.0, -700.0]
    g = r.normal(size=(K, crop, crop, C)).astype(np.float32)
    theta = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), H, H, 2.0,
                        crop, 0.0, 0.75)
    grid = j_affine_grid(theta, crop, crop)
    _, vjp = jax.vjp(j_grid_sample_shared, jnp.asarray(feats), grid)
    d_img, d_grid = vjp(jnp.asarray(g))
    _, vjp_p = jax.vjp(lambda i: grid_sample_shared_pallas(i, grid, True),
                       jnp.asarray(feats))
    (d_img_p,) = vjp_p(jnp.asarray(g))
    assert not np.any(np.asarray(d_grid))

    tgrid, tg = _t(grid)[None], _t(g)[None]
    plain = warp.grid_sample_shared_bwd(tg, tgrid, H, H)
    assert_close("train.crop_bwd_vs_jax", plain[0], d_img, atol=1e-5)
    assert_close("train.crop_bwd_vs_pallas", plain[0], d_img_p, atol=1e-5)
    src = _t(feats)[None].requires_grad_(True)
    tgrid.requires_grad_(True)
    out = warp.CropShared.apply(src, tgrid)
    out.backward(tg)
    assert tgrid.grad is None
    assert torch.equal(src.grad, plain)
    if far:   # a crop wholly outside adds nothing
        alone = warp.grid_sample_shared_bwd(tg[:, -1:], _t(grid)[None, -1:],
                                            H, H)
        assert float(alone.abs().max()) == 0.0


def test_crop_feature_and_its_gradient_match_jax():
    r = np.random.default_rng(11)
    B, H, C, crop = 2, 32, 16, 16
    feats = r.normal(size=(B, H, H, C)).astype(np.float32)
    locs = r.uniform(-3, 3, (B, 2)).astype(np.float32)
    oris = r.uniform(-0.5, 0.5, (B,)).astype(np.float32)
    g = r.normal(size=(B, crop, crop, C)).astype(np.float32)
    kw = dict(pixels_per_meter=2.0, crop_size=crop, offset_y=0.75)
    ref, vjp = jax.vjp(lambda f: j_crop_feature(
        f, jnp.asarray(locs), jnp.asarray(oris), **kw), jnp.asarray(feats))
    (d_ref,) = vjp(jnp.asarray(g))
    src = _t(feats).requires_grad_(True)
    out = warp.crop_feature(src, _t(locs), _t(oris), **kw)
    out.backward(_t(g))
    assert_close("train.crop_feature", out.detach(), ref, atol=5e-5)
    assert_close("train.crop_feature_grad", src.grad, d_ref, atol=1e-4)


def _canvas_case():
    """Two items, a 3x4 canvas each: ties of 2 and 3 points, ties at 0,
    invalid points (one above every valid value) and empty cells."""
    r = np.random.default_rng(5)
    B, P, C, nx, ny = 2, 12, 5, 4, 3
    G = nx * ny
    feat = r.uniform(0.1, 2.0, (B, P, C)).astype(np.float32)
    pid = r.integers(0, 6, (B, P)).astype(np.int32)     # cells 6-11 empty
    keep = np.ones((B, P), bool)
    pid[0, :2] = 1
    feat[0, 1] = feat[0, 0]                # a tie of 2 in every channel
    pid[0, 2:5] = 2
    feat[0, 2:5, 3] = 1.5                  # a tie of 3 in channel 3
    feat[1, :4, :2] = 0.0                  # ties at 0
    pid[1, :4] = 4
    feat[1, 4:, :2] = np.minimum(feat[1, 4:, :2], 0.0)
    keep[1, 10:] = False                   # invalid, one above the rest
    feat[1, 10] = 9.0
    pid[1, 10:] = G                        # the dump slot
    g = r.normal(size=(B, ny, nx, C)).astype(np.float32)
    return feat, pid, keep, g, (B, P, C, nx, ny)


def test_canvas_max_backward_matches_jax_grad():
    feat, pid, keep, g, (B, P, C, nx, ny) = _canvas_case()
    G = nx * ny
    neg = jnp.asarray(-1e30, jnp.float32)

    def j_canvas(f):   # lav_tpu ops/pillar.py:516-522
        f = jnp.where(jnp.asarray(keep)[..., None], f, neg)
        pid_flat = (jnp.asarray(pid) + jnp.arange(B)[:, None] * (G + 1))
        canvas = jnp.full((B * (G + 1), C), neg).at[
            pid_flat.reshape(-1)].max(f.reshape(-1, C))
        canvas = jnp.where(canvas > neg, canvas, 0.0)
        return canvas.reshape(B, G + 1, C)[:, :G].reshape(B, ny, nx, C)

    ref, vjp = jax.vjp(j_canvas, jnp.asarray(feat))
    (d_ref,) = vjp(jnp.asarray(g))
    canvas_pid = np.where(keep, pid + np.arange(B)[:, None] * G, B * G)
    f = _t(feat).reshape(-1, C).requires_grad_(True)
    out = TP.CanvasMax.apply(f, _t(canvas_pid.astype(np.int32)).reshape(-1),
                             B * G)
    out.backward(_t(g).reshape(-1, C))
    assert_close("train.canvas_max", out.detach().reshape(B, ny, nx, C), ref,
                 atol=0)
    assert_close("train.canvas_max_bwd", f.grad.reshape(B, P, C), d_ref,
                 atol=0)
    d = f.grad.reshape(B, P, C)
    assert torch.equal(d[0, 0], d[0, 1]) and float(d[0, 0].abs().min()) > 0
    assert float(d[1, 10:].abs().max()) == 0.0


def test_canvas_max_backward_splits_ties_as_jax_does():
    """jax.grad of full((3, 1), -1e30).at[[0, 0, 0, 1]].max(...) weighted
    by rows 1, 2, 3 gives [0.5, 0.5, 0, 2]; the port's pid 2 is empty."""
    feat = torch.tensor([[2.0], [2.0], [1.0], [5.0]], requires_grad=True)
    pid = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    out = TP.CanvasMax.apply(feat, pid, 3)
    (out * torch.tensor([[1.0], [2.0], [3.0]])).sum().backward()
    assert feat.grad.flatten().tolist() == [0.5, 0.5, 0.0, 2.0]


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_jax(masked):
    r = np.random.default_rng(7 + masked)
    C = 6
    shape = (40, C) if masked else (3, 5, 4, C)   # points, or NHWC maps
    x = r.normal(1.0, 2.0, shape).astype(np.float32)
    mask = (r.uniform(size=shape[:-1]) > 0.3) if masked else None
    p = {"scale": r.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": r.normal(size=C).astype(np.float32),
         "mean": r.normal(size=C).astype(np.float32),
         "var": r.uniform(0.5, 2.0, C).astype(np.float32)}
    g = r.normal(size=shape).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jm = None if mask is None else jnp.asarray(mask)

    def f(pp, xx):
        return JLay.batchnorm(pp, xx, True, mask=jm, eps=1e-3,
                              momentum=0.01)

    (y, st), vjp = jax.vjp(f, jp, jnp.asarray(x))
    d_p, d_x = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, st)))
    bn = BatchNorm(C, eps=1e-3, dim=-1 if masked else 1, momentum=0.01)
    load_jax_params(bn, p).train()
    tx = _t(x).requires_grad_(True)
    # the port's maps are NCHW
    xin = tx if masked else tx.permute(0, 3, 1, 2)
    out = bn(xin, mask=None if mask is None else _t(mask))
    out = out if masked else out.permute(0, 2, 3, 1)
    out.backward(_t(g))
    assert_close("train.bn_y", out.detach(), y, atol=1e-5)
    assert_close("train.bn_dx", tx.grad, d_x, atol=1e-5)
    assert_close("train.bn_dscale", bn.scale.grad, d_p["scale"], atol=1e-5)
    assert_close("train.bn_dbias", bn.bias.grad, d_p["bias"], atol=1e-5)
    state = bn_state(bn)[""]
    assert torch.equal(bn.mean, _t(p["mean"]))    # not applied yet
    merge_bn_state(bn)
    assert bn.new_stats is None
    for k, v in zip(("mean", "var"), state):
        assert_close(f"train.bn_state_{k}", v, st[k], atol=1e-5)
        assert_close(f"train.bn_merged_{k}", getattr(bn, k), st[k],
                     atol=1e-5)


def test_point_pillar_train_route_matches_jax():
    cfg, tcfg = tiny_config(), t_tiny_config()
    geo = dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
               max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)
    params = JP.point_pillar_init(jax.random.key(3), cfg.num_input,
                                  cfg.num_features)
    r = np.random.default_rng(9)
    B, P = 2, 96
    pts = r.uniform(-6, 14, (B, P, cfg.num_input - 5)).astype(np.float32)
    pts[0, 1] = pts[0, 0]                   # a duplicate point: a tie
    valid = r.uniform(size=(B, P)) > 0.1
    ny, nx = cfg.ny, cfg.nx
    g = r.normal(size=(B, ny, nx, cfg.num_features[-1])).astype(np.float32)

    def f(pp):
        return JP.point_pillar_apply(pp, jnp.asarray(pts), jnp.asarray(valid),
                                     num_features=cfg.num_features,
                                     train=True, **geo)

    @jax.jit
    def fwd_bwd(pp, gg):
        (c, s), vjp = jax.vjp(f, pp)
        return c, s, vjp((gg, jax.tree.map(jnp.zeros_like, s)))[0]

    canvas, st, d_p = fwd_bwd(params, jnp.asarray(g))
    pp = TP.PointPillar(tcfg.num_input, tcfg.num_features, **geo)
    load_jax_params(pp, jax.tree.map(np.asarray, params)).train()
    out = pp(_t(pts), _t(valid))
    out.backward(_t(g))
    assert_close("train.pillar_canvas", out.detach(), canvas, atol=1e-5,
                 rtol=1e-5)
    state = bn_state(pp)
    for i in range(len(cfg.num_features)):
        for j, k in enumerate(("mean", "var")):
            assert_close(f"train.pillar_bn_{k}", state[f"bn_{i}"][j],
                         st[f"bn_{i}"][k], atol=1e-5, rtol=1e-5)
        lin = getattr(pp, f"linear_{i}")
        assert_close("train.pillar_dw", lin.w.grad.T,
                     d_p[f"linear_{i}"]["w"], atol=1e-5, rtol=1e-5)
        bn = getattr(pp, f"bn_{i}")
        assert_close("train.pillar_dscale", bn.scale.grad,
                     d_p[f"bn_{i}"]["scale"], atol=1e-5, rtol=1e-5)


def test_losses_match_jax():
    r = np.random.default_rng(13)
    B, K, C, T, I, H = 3, 4, 6, 5, 2, 8

    def u(*s, lo=0.0, hi=1.0):
        return r.uniform(lo, hi, s).astype(np.float32)

    def n(*s):
        return r.normal(size=s).astype(np.float32)

    hm_p, hm = n(B, 2, H, H), u(B, 2, H, H)
    size_p, size = n(B, 2, H, H) * 3, u(B, 2, H, H, hi=8)
    ori_p, ori = n(B, 2, H, H), u(B, 2, H, H, lo=-1)
    plan, tgt = n(B, I, C, T, 2), n(B, T, 2)
    cast_s, cast_e = n(B, K, C, T, 2), n(B, K, C, T, 2)
    other_gt = n(B, K, T, 2)
    probs, probs_e = u(B, K, C, lo=0.01, hi=0.99), u(B, K, C)
    valid = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 0]], bool)
    cmds = np.array([0, 5, 2], np.int32)
    w = u(B, hi=5)
    idxs = np.array([True, False, True])
    J, T_ = jnp.asarray, _t
    cases = [
        ("det_loss", JL.det_loss(J(hm_p), J(hm), J(size_p), J(size),
                                 J(ori_p), J(ori)),
         TL.det_loss(T_(hm_p), T_(hm), T_(size_p), T_(size), T_(ori_p),
                     T_(ori))),
        ("bce", JL.bce(J(probs), J(probs_e)), TL.bce(T_(probs), T_(probs_e))),
        ("plan_loss_all_cmds", JL.plan_loss_all_cmds(J(plan), J(tgt)),
         TL.plan_loss_all_cmds(T_(plan), T_(tgt))),
        ("plan_loss_all_cmds_w", JL.plan_loss_all_cmds(
            J(plan), J(tgt), idxs=J(idxs), item_weights=J(w)),
         TL.plan_loss_all_cmds(T_(plan), T_(tgt), idxs=T_(idxs),
                               item_weights=T_(w))),
        ("gather_cmd", JL.gather_cmd(J(plan[:, 0]), J(cmds)),
         TL.gather_cmd(T_(plan[:, 0]), T_(cmds))),
        ("distill_l1", JL.distill_l1(J(cast_s[:, 0]), J(cast_e[:, 0])),
         TL.distill_l1(T_(cast_s[:, 0]), T_(cast_e[:, 0]))),
        ("distill_l1_valid", JL.distill_l1(J(cast_s), J(cast_e), J(valid)),
         TL.distill_l1(T_(cast_s), T_(cast_e), T_(valid))),
        ("cmd_distill_bce", JL.cmd_distill_bce(J(probs), J(probs_e),
                                               J(valid)),
         TL.cmd_distill_bce(T_(probs), T_(probs_e), T_(valid))),
        ("cmd_bce", JL.cmd_bce(J(probs[:, 0]), J(cmds), C, smooth=0.2),
         TL.cmd_bce(T_(probs[:, 0]), T_(cmds), C, smooth=0.2)),
        ("masked_mean", JL.masked_mean(J(w), J(idxs)),
         TL.masked_mean(T_(w), T_(idxs))),
        ("masked_mean_none", JL.masked_mean(J(w), J(np.zeros(B, bool))),
         TL.masked_mean(T_(w), T_(np.zeros(B, bool)))),
        ("other_cast_loss_min_mode", JL.other_cast_loss_min_mode(
            J(cast_s), J(other_gt), J(valid)),
         TL.other_cast_loss_min_mode(T_(cast_s), T_(other_gt), T_(valid))),
    ]
    for name, ref, out in cases:
        ref = ref if isinstance(ref, tuple) else (ref,)
        out = out if isinstance(out, tuple) else (out,)
        for a, b in zip(out, ref):
            assert_close(f"train.loss.{name}", a, b, atol=1e-6, rtol=1e-6)


def test_select_cars_ties_go_to_the_lowest_index():
    """More non-qualifying slots (score -inf) than cars: the invalid
    slots' indices are lax.top_k's, the lowest first."""
    r = np.random.default_rng(17)
    B, N, T, K = 3, 9, 4, 4
    ego = r.normal(size=(B, T + 1, 2)).astype(np.float32)
    locs = r.normal(size=(B, N, T + 1, 2)).astype(np.float32)
    typs = r.integers(0, 2, (B, N)).astype(np.int32)
    typs[1] = 0                                  # no car qualifies
    typs[2, :] = 0
    typs[2, 6] = 1
    locs[2, 6, 0, 1] = ego[2, 0, 1] - 1.0        # one car, ahead
    key = jax.random.key(4)
    scores = np.asarray(jax.random.uniform(key, (B, N)))
    j_idx, j_valid = j_select_cars(key, jnp.asarray(ego), jnp.asarray(locs),
                                   jnp.zeros((B, N)), jnp.asarray(typs), K)
    idx, valid = select_cars(_t(scores), _t(ego), _t(locs), _t(typs), K)
    assert idx.tolist() == np.asarray(j_idx).tolist()
    assert valid.tolist() == np.asarray(j_valid).tolist()
    assert valid[2].tolist() == [True, False, False, False]
