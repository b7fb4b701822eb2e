"""The port's bf16 distillation pieces against lav_tpu's on the CPU: the
plain bf16 forms of the step's two backward kernels, the point pillar's
train route on bf16 points, and the v2 "full" step with
`compute_dtype=bfloat16` (lav_tpu's `--dtype bfloat16`).

* The crop's source gradient in bf16 (`warp.grid_sample_shared_bwd`, the
  plain version of kernel `crop_shared_bwd_bf16`, and `CropShared`'s
  backward) against `jax.vjp` of lav_tpu's `grid_sample_shared` on bf16
  features.  Both round each tap's weight and each product g * weight to
  bf16; the port sums the products in f32 and rounds once, lav_tpu adds
  them in bf16 by four scatter-adds.  So each cell is held to
  CROP_BWD_ULPS = 4 bf16 ulps of its sum of |g w| (the ulp of the power of
  two below it, 2^-7 of it): measured <= 3.0 ulps on these cases.
* The canvas max's gradient in bf16 (`pillar_scatter_max_bwd_plain`, the
  plain version of kernel `pillar_scatter_max_bwd_bf16`, and the sorted
  form through `CanvasMax`) against `jax.vjp` of lav_tpu's train route
  (`ops/pillar.py:516-522`) on bf16 features: exact, on rows of 1, 3,
  255, 256, 257 and 300 tied points (JAX counts ties by a sum of bf16
  ones, which stops at 256: a share of 1/256 from 256 ties on), ties at
  0, invalid points and empty cells.
* The point pillar's train route on bf16 points against
  `point_pillar_apply(train=True)`: equal pillar ids (each side floors
  the bf16 coordinates as lav_tpu does and clamps the index in f32 /
  int32, never in bf16), so the canvas
  differs only where the bf16 point MLPs round differently: to atol 1/16
  (measured 1/32, on 1.3% of the elements, at the ReLU's edge; values up
  to 3.4), the BN state to rtol 5e-3 + atol 1e-3 (measured 1.6e-3
  relative), the f32 weight and BN scale gradients to 10% in L2 (measured
  <= 3.3%).
* The v2 "full" step in bf16 against lav_tpu's
  `make_full_train_step(..., compute_dtype=jnp.bfloat16)`, one step from
  the same params, batch and draws (tests/test_torch_train.py's setup),
  at tiny_config with crops of 64 (see below), B = 8.  Params, Adam's
  moments and the BN statistics stay f32 on both sides.  The step's
  gradient leaves are not comparable in train mode at this size:
  lav_tpu's own bf16 step lies a median 130% (in L2) from its f32 step
  on the same (bf16-valued) points, as train-mode BatchNorm's backward
  takes the batch means out of bf16 gradients and leaves mostly their
  rounding (B = 32, or 64 times the points, left it at 116-140%).  So
  the step is held
    - in each loss term to rtol 5e-2 (measured <= 2.1e-2, the motion
      terms; the perception terms <= 1.4e-3) and the total loss to rtol
      2e-3 (measured 5.1e-4);
    - in grad_norm to rtol 0.3 (measured 0.20);
    - in every BN running statistic, in L2, to 0.1 of its norm + 1e-4
      (measured <= 5.9e-2, the means of the crop ResNet's layer4 and
      stem);
  and its gradients are held with BatchNorm on its running statistics
  (the port's models in eval mode; lav_tpu's forward with train=False),
  where bf16 rounding is not amplified, in one bf16 forward and backward
  of the v2 loss, "full" and "motion_only" (whose lidar-model gradients
  come only through the crops' backward: with that backward's sign
  flipped in a scratch copy, "motion_only" fails and "full" does not):
    - the loss to rtol 1e-4 (measured 1.5e-6 / 1.6e-5);
    - each gradient leaf, in L2, to 0.15 of the nearer of lav_tpu's two
      gradients, its bf16 one and its f32 one on the same inputs, plus
      1e-6 grad_norm (measured, on the leaves above that floor: <= 0.080
      / 0.102 from lav_tpu's bf16 gradient on 94 / 74 leaves, and <=
      0.035 from its f32 one on the other 13 / 0; a zeroed leaf lies
      1.0 and a sign-flipped one 2.0 from both).  Two references,
      because XLA's CPU backend adds a bf16 gradient over the batch and
      the map in bf16: lav_tpu's bf16 gradients of the lidar model's
      decoder and head biases and BN scales lie 17-93% from its f32
      ones, where the port, which adds in f32, lies within 9% (within
      0.3% for the heads' biases).  At most 20 leaves take the f32 one;
    - grad_norm to rtol 2e-3 of lav_tpu's f32 one (measured 3.9e-4 /
      7.7e-5).
  lav_tpu's own test holds its bf16 loss to 12% of its f32 loss
  (tests/test_train.py:138).  Crops of 64 and not tiny_config's 16:
  PyTorch's CPU bf16 conv returns NaN weight gradients now and then for a
  3x3 stride-2 conv on a 1x1 map of 128 channels or more, which the crop
  ResNet's layer4 meets at crops of 16; at 32 it meets none (the card's
  convs do not have this fault).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from lav_tpu.config import tiny_config
from lav_tpu.core.warp import (
    _crop_theta, affine_grid as j_affine_grid,
    grid_sample_shared as j_grid_sample_shared,
)
from lav_tpu.models.lidar import lidar_model_apply
from lav_tpu.models.planner import uniplanner_forward
from lav_tpu.ops import pillar as JP
from lav_tpu.train.distill import make_distill_forward, make_distill_loss_fn
from lav_tpu.utils.tree import merge_bn_state as j_merge_bn_state
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.core import warp
from lav_tpu_torch.ops import pillar as TP
from lav_tpu_torch.train import distill as TD
from lav_tpu_torch.utils.tree import bn_state
from lav_tpu_torch.utils.weights import load_jax_params
from tests import test_torch_train as T
from tests.torch_parity import assert_close

BF = jnp.bfloat16
CROP_BWD_ULPS = 4
CROP = 64                 # the step's crop size (see the module note)
B_STEP = 8
LOSS_RTOL, TERM_RTOL, TRAIN_GNORM_RTOL = 2e-3, 5e-2, 0.3
STAT_L2, STAT_FLOOR = 1e-1, 1e-4
EVAL_LOSS_RTOL, EVAL_GNORM_RTOL = 1e-4, 2e-3
LEAF_L2, LEAF_FLOOR, MAX_NEARER_F32 = 0.15, 1e-6, 20
# the point pillar's train route in bf16 (see the module note)
PILLAR_CANVAS_ATOL, PILLAR_BN_RTOL, PILLAR_GRAD_L2 = 1 / 16, 5e-3, 1e-1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16(x):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(x).astype(BF)
    return j, _t(j.astype(jnp.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("case", [
    # (seed, K, H, C, crop)
    (3, 3, 40, 64, 24),
    (5, 4, 40, 16, 32),
    (6, 6, 24, 8, 24),
])
def test_crop_backward_bf16_matches_jax_vjp(case):
    seed, K, H, C, crop = case
    r = np.random.default_rng(seed)
    feats = r.normal(size=(H, H, C)).astype(np.float32)
    locs = r.uniform(-2, 2, (K, 2)).astype(np.float32)
    oris = r.uniform(-np.pi, np.pi, (K,)).astype(np.float32)
    g = r.normal(size=(K, crop, crop, C)).astype(np.float32)
    theta = _crop_theta(jnp.asarray(locs), jnp.asarray(oris), H, H, 2.0,
                        crop, 0.0, 0.75)
    grid = j_affine_grid(theta, crop, crop)
    jf, tf = _bf16(feats)
    jg, tg = _bf16(g)
    _, vjp = jax.vjp(j_grid_sample_shared, jf, grid)
    d_img, d_grid = vjp(jg)
    assert d_img.dtype == BF and not np.any(np.asarray(d_grid))

    tgrid = _t(grid)[None]
    plain = warp.grid_sample_shared_bwd(tg[None], tgrid, H, H)
    assert plain.dtype == torch.bfloat16
    mag = warp.grid_sample_shared_bwd(tg[None].abs(), tgrid, H, H)[0]
    ulp = torch.exp2(torch.floor(torch.log2(mag.float().clamp(min=1e-30)))
                     - 7)
    err = (plain[0].float() - _t(d_img.astype(jnp.float32))).abs()
    worst = float((err / ulp).max())
    assert_close("train_bf16.crop_bwd_ulps", worst, 0.0, atol=CROP_BWD_ULPS)
    src = tf[None].clone().requires_grad_(True)
    out = warp.CropShared.apply(src, tgrid)
    assert out.dtype == torch.bfloat16
    out.backward(tg[None])
    assert torch.equal(src.grad, plain)


def _tie_case():
    """One item: row i of rows 0-5 holds n = 1, 3, 255, 256, 257, 300
    points tied at 0 in channel 0 (the post-ReLU ties) and at 1.5 in
    channel 3; random values elsewhere; 4 invalid points, one above every
    valid value; rows 6+ empty."""
    r = np.random.default_rng(21)
    sizes = (1, 3, 255, 256, 257, 300)
    nx, ny, C = 4, 3, 4
    pid = np.concatenate([np.full(n, i) for i, n in enumerate(sizes)])
    P = pid.size + 4
    feat = r.uniform(0.1, 2.0, (1, P, C)).astype(np.float32)
    feat[0, :, 0] = 0.0
    feat[0, :, 3] = 1.5
    keep = np.ones((1, P), bool)
    keep[0, -4:] = False
    feat[0, -4] = 9.0
    pid = np.concatenate([pid, np.full(4, nx * ny)]).astype(np.int32)[None]
    g = r.normal(size=(1, ny, nx, C)).astype(np.float32)
    return feat, pid, keep, g, (1, P, C, nx, ny), sizes


def test_canvas_backward_bf16_matches_jax_exactly():
    feat, pid, keep, g, (B, P, C, nx, ny), sizes = _tie_case()
    G = nx * ny
    neg = jnp.asarray(-1e30, BF)
    jf, tf = _bf16(feat)
    jg, tg = _bf16(g)

    def j_canvas(f):   # lav_tpu ops/pillar.py:516-522, bf16
        f = jnp.where(jnp.asarray(keep)[..., None], f, neg)
        canvas = jnp.full((B * (G + 1), C), neg, BF).at[
            jnp.asarray(pid).reshape(-1)].max(f.reshape(-1, C))
        canvas = jnp.where(canvas > neg, canvas, 0.0)
        return canvas.reshape(B, G + 1, C)[:, :G].reshape(B, ny, nx, C)

    ref, vjp = jax.vjp(j_canvas, jf)
    (d_ref,) = vjp(jg)
    assert d_ref.dtype == BF
    d_ref = d_ref.astype(jnp.float32)
    canvas_pid = _t(np.where(keep, pid, B * G).astype(np.int32)).reshape(-1)
    f = tf.reshape(-1, C).clone().requires_grad_(True)
    out = TP.CanvasMax.apply(f, canvas_pid, B * G)   # the sorted form
    out.backward(tg.reshape(-1, C))
    assert out.dtype == f.grad.dtype == torch.bfloat16
    assert_close("train_bf16.canvas", out.detach().reshape(B, ny, nx, C),
                 ref.astype(jnp.float32), atol=0)
    assert_close("train_bf16.canvas_bwd_sorted", f.grad.reshape(B, P, C),
                 d_ref, atol=0)
    canvas = out.detach()
    # the plain form, with the invalid points' ids negative and past S
    pid_plain = canvas_pid.clone()
    pid_plain[-2:] = -1
    plain = TP.pillar_scatter_max_bwd_plain(tg.reshape(-1, C),
                                            f.detach(), pid_plain, canvas)
    assert_close("train_bf16.canvas_bwd_plain", plain.reshape(B, P, C),
                 d_ref, atol=0)
    # 1/256 from 256 ties on: the shares of 300 ties sum past g
    start = np.cumsum((0,) + sizes)
    gcell = tg.reshape(-1, C)[5, 0].float()
    share = plain[start[5]:start[6], 0].float()
    assert torch.equal(share, torch.full_like(share, float(
        (gcell * torch.tensor(1 / 256)).to(torch.bfloat16))))
    assert float(plain[-4:].abs().max()) == 0.0


def test_point_pillar_bf16_train_route_matches_jax():
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
    jpts, tpts = _bf16(pts)
    jg, tg = _bf16(r.normal(size=(B, ny, nx, cfg.num_features[-1])))

    def f(pp):
        return JP.point_pillar_apply(pp, jpts, jnp.asarray(valid),
                                     num_features=cfg.num_features,
                                     train=True, **geo)

    @jax.jit
    def fwd_bwd(pp, gg):
        (c, s), vjp = jax.vjp(f, pp)
        return c, s, vjp((gg, jax.tree.map(jnp.zeros_like, s)))[0]

    canvas, st, d_p = fwd_bwd(params, jg)
    assert canvas.dtype == BF
    # the pillar ids: the same from the bf16 points on both sides
    ids = [JP.compute_pillar_ids(jpts, jnp.asarray(valid), nx=nx, ny=ny,
                                 **geo),
           TP.compute_pillar_ids(tpts, _t(valid), nx=nx, ny=ny, **geo)]
    for j, t in zip(*ids):
        assert np.array_equal(np.asarray(j), t.numpy())
    pp = TP.PointPillar(tcfg.num_input, tcfg.num_features, **geo)
    load_jax_params(pp, jax.tree.map(np.asarray, params)).train()
    out = pp(tpts, _t(valid))
    assert out.dtype == torch.bfloat16
    out.backward(tg)
    assert_close("train_bf16.pillar_canvas", out.detach(),
                 canvas.astype(jnp.float32), atol=PILLAR_CANVAS_ATOL)
    state = bn_state(pp)
    for i in range(len(cfg.num_features)):
        for j, k in enumerate(("mean", "var")):
            assert_close(f"train_bf16.pillar_bn_{k}", state[f"bn_{i}"][j],
                         st[f"bn_{i}"][k], atol=1e-3, rtol=PILLAR_BN_RTOL)
        lin = getattr(pp, f"linear_{i}")
        bn = getattr(pp, f"bn_{i}")
        assert lin.w.grad.dtype == torch.float32
        for got, want in ((lin.w.grad.T, d_p[f"linear_{i}"]["w"]),
                          (bn.scale.grad, d_p[f"bn_{i}"]["scale"])):
            want = _t(want)
            assert float((got - want).norm()) <= PILLAR_GRAD_L2 * float(
                want.norm()), (i, float((got - want).norm() / want.norm()))


def _ref_step(cfg, batch_j):
    """lav_tpu's make_full_train_step body (v2 "full", bf16), jitted, with
    the gradients (tests/test_torch_train.py's `_ref_step` in bf16)."""
    fwd = make_distill_forward(cfg, v2=True, mode="full", compute_dtype=BF)
    opt = optax.adam(T.LR)

    @jax.jit
    def step(params, opt_state, rng):
        (_, (state, metrics)), grads = jax.value_and_grad(
            lambda p: fwd(p, batch_j, rng), has_aux=True)(params)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = j_merge_bn_state(optax.apply_updates(params, updates),
                                  state)
        return metrics, params, opt_state

    return step, opt


def test_v2_full_bf16_step_matches_lav_tpu():
    cfg = tiny_config(crop_size=CROP)
    tcfg = t_tiny_config(crop_size=CROP)
    params, batch, batch_j = T._setup(B_STEP)
    rng = jax.random.key(1)
    ref_step, opt = _ref_step(cfg, batch_j)
    m_b, p_b, o_b = ref_step(params, opt.init(params), rng)
    assert all(v.dtype == jnp.float32 for v in jax.tree.leaves(
        (p_b, o_b)) if hasattr(v, "dtype") and v.dtype != jnp.int32)

    models = T._port_models(params)
    optimizer = TD.adam(models, T.LR)
    step = TD.make_full_train_step(tcfg, v2=True, mode="full",
                                   compute_dtype=torch.bfloat16)
    metrics = step(models, optimizer, batch,
                   noise=T._jax_noise(rng, B_STEP))
    # params, Adam's moments and the BN statistics stay f32
    assert {p.dtype for p in models.parameters()} == {torch.float32}
    assert {b.dtype for b in models.buffers()} == {torch.float32}
    assert {v.dtype for s in optimizer.state.values() for k, v in s.items()
            if k != "step"} == {torch.float32}

    for k, v in m_b.items():
        rtol = dict(loss=LOSS_RTOL, grad_norm=TRAIN_GNORM_RTOL).get(
            k, TERM_RTOL)
        assert_close(f"train_bf16.{k}", metrics[k], v, atol=0, rtol=rtol)
    want = dict(T._as_port(p_b).named_buffers())
    for name, b in models.named_buffers():
        err = float((b - want[name]).norm())
        assert err <= STAT_L2 * float(want[name].norm()) + STAT_FLOOR, (
            name, err, float(want[name].norm()))


def _ref_grads(cfg, mode, params, batch_j, rng, compute_dtype):
    """jax.value_and_grad of lav_tpu's v2 forward in `mode` with BatchNorm
    on its running statistics (`make_distill_forward`'s body with
    train=False), jitted: (loss, grads)."""
    geo = dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
               max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter,
               num_features=cfg.num_features)
    loss_terms = make_distill_loss_fn(cfg, v2=True, mode=mode)
    cdt = compute_dtype

    def forward(p):
        feats, hm, size, ori, pred_bev, _ = lidar_model_apply(
            p["lidar_model"], batch_j["lidar"].astype(cdt),
            batch_j["lidar_valid"], train=False, **geo)
        out, _ = uniplanner_forward(
            p["uniplanner"], cfg, feats, batch_j["bev"].astype(cdt),
            batch_j["ego_locs"], batch_j["locs"], batch_j["oris"],
            batch_j["nxps"], batch_j["typs"], rng, train=False)
        preds = tuple(x.astype(jnp.float32)
                      for x in (hm, size, ori, pred_bev))
        return loss_terms(preds, out, batch_j)[0]

    return jax.jit(jax.value_and_grad(forward))(params)


@pytest.mark.parametrize("mode", ["full", "motion_only"])
def test_v2_bf16_gradients_match_lav_tpu(mode):
    """The bf16 step's gradients with BatchNorm on its running statistics
    (see the module note)."""
    cfg = tiny_config(crop_size=CROP)
    tcfg = t_tiny_config(crop_size=CROP)
    params, batch, batch_j = T._setup(B_STEP)
    rng = jax.random.key(1)
    loss_b, g_b = _ref_grads(cfg, mode, params, batch_j, rng, BF)
    # lav_tpu in f32 on the same inputs: the bf16 points' values
    same = dict(batch_j, lidar=batch_j["lidar"].astype(BF).astype(
        jnp.float32))
    _, g_f = _ref_grads(cfg, mode, params, same, rng, jnp.float32)

    models = T._port_models(params).eval()
    forward = TD.make_distill_forward(tcfg, v2=True, mode=mode,
                                      compute_dtype=torch.bfloat16)
    loss, _ = forward(models, batch, T._jax_noise(rng, B_STEP))
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in models.named_parameters() if p.requires_grad}
    want_b = dict(T._as_port(g_b).named_parameters())
    want_f = {n: p.detach().clone() for n, p in
              T._as_port(g_f).named_parameters()}
    # lav_tpu's global norm also counts the running statistics' gradients
    gn, gn_f = (float(torch.sqrt(sum((g[n].detach() ** 2).sum()
                                     for n in grads)))
                for g in (grads, want_f))
    assert_close("train_bf16.eval_loss", loss, loss_b, atol=0,
                 rtol=EVAL_LOSS_RTOL)
    nearer_f32 = []
    for name, got in grads.items():
        errs = [float((got - want[name].detach()).norm())
                - LEAF_L2 * float(want[name].detach().norm())
                for want in (want_b, want_f)]
        if errs[1] < errs[0]:
            nearer_f32.append(name)
        assert min(errs) <= LEAF_FLOOR * gn_f, (name, errs)
    assert len(nearer_f32) <= MAX_NEARER_F32, nearer_f32
    assert_close("train_bf16.eval_grad_norm", gn, gn_f, atol=0,
                 rtol=EVAL_GNORM_RTOL)

