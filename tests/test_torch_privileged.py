"""The port's BEV planner trainer (lav_tpu_torch.train.privileged) and its
forwards against lav_tpu's on the CPU, at tiny_config, B = 8.

lav_tpu's step is `make_bev_train_step`'s body, jitted: value_and_grad of
`bev_planner_forward` (train=True) through `make_bev_loss_fn`,
`optax.global_norm`, `optax.adam(3e-4)` and `merge_bn_state`; it also
returns the gradients.  The params come from the port's initialiser
(seed 0), turned into lav_tpu's tree (`torch_parity.jax_tree`), and the
port's planner loads that tree again.  The batch is `bev_batch`'s (numpy
seed 0) with varied commands, brake flags, orientations and vehicle
types, so that the v2 loss masks and weights items and the car pick has
cars to skip.  The port takes lav_tpu's draws: the uniforms
`bev_planner_forward` draws from its key, split as it splits it
(`_jax_noise`).  v1 runs one step; v2 (branch weights of v2_config,
other_weight 0.37) one and a second, for which the port first loads
lav_tpu's params of after step 1 (its Adam moments stay its own).

Tolerances, f32, each above what was measured here with a margin of 10x
or more (the measurements in brackets).  The crop ResNet's layer4 runs
train-mode BN over 1x1 maps of B * K = 16 and B = 8 crops, which
amplifies rounding; the crops themselves differ by up to ~3e-5 (lav_tpu's
linspace against torch's, tests/test_torch_warp.py).  Against the
distillation step's tolerances (tests/test_torch_train.py) the leaves are
held ten times tighter, as this step is far better conditioned:
  * the loss terms to rtol 1e-4 [<= 2.5e-6];
  * grad_norm to rtol 1e-3 [<= 3.3e-6];
  * each gradient leaf in L2 to 2e-3 of its norm + 1e-6 grad_norm
    [<= 3.8e-5] (the floor covers the biases before a BatchNorm, whose
    exact gradient is 0), all leaves to 1e-3 of grad_norm [<= 3.9e-5];
  * the updated params as tests/test_torch_train.py holds them
    (`torch_parity.check_update`): 1e-7 after step 1, 1e-2 lr after
    step 2 where the gradients agree, Adam's bound elsewhere;
  * the BN running statistics, ego wins, to atol = rtol = 1e-5
    [<= 9e-7].
Also `bev_planner_forward` in eval mode (no jitter, running statistics)
and `bev_planner_infer` against lav_tpu to atol 1e-5 [<= 2.4e-7],
`bev_planner_infer` against tests/golden/bev_planner_infer.npz at the
golden's own atol 1e-4 / rtol 1e-3, and `step_lr` against
optax.exponential_decay(staircase=True).
"""

import os

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.models.planner import (
    bev_planner_forward as j_forward, bev_planner_infer as j_infer,
    bev_planner_init,
)
from lav_tpu.train.privileged import make_bev_loss_fn as j_loss_fn
from lav_tpu.utils.tree import merge_bn_state as j_merge_bn_state
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.models.planner import (
    BEVPlanner, bev_planner_forward, bev_planner_infer,
)
from lav_tpu_torch.train import privileged as TP
from lav_tpu_torch.train.distill import adam
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import (
    assert_close, check_grads, check_update, jax_tree,
)

BW = [5, 5, 5, 1, 1, 1]          # v2_config().branch_weights
B, LR, OTHER_WEIGHT = 8, 3e-4, 0.37
TOL = dict(metric=1e-4, grad_norm=1e-3, leaf=2e-3, all=1e-3, floor=1e-6)
STAT_TOL, STEP2_UPD_TOL, EVAL_ATOL = 1e-5, 1e-2 * LR, 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "bev_planner_infer.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _cfgs(v2):
    kw = dict(branch_weights=BW) if v2 else {}
    return tiny_config(**kw), t_tiny_config(**kw)


def _setup(tcfg):
    """lav_tpu params (from the port's initialiser) and the batch for both
    sides."""
    params = jax.tree.map(jnp.asarray, jax_tree(
        BEVPlanner(tcfg, torch.Generator().manual_seed(0))))
    batch = TP.bev_batch(tcfg, B, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    N = tcfg.max_objs
    batch.update(
        cmds=torch.from_numpy(rng.integers(0, 6, B).astype(np.int32)),
        bras=torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)),
        oris=torch.from_numpy(rng.uniform(-np.pi, np.pi, (B, N))
                              .astype(np.float32)),
        typs=torch.from_numpy(rng.integers(0, 2, (B, N)).astype(np.int32)))
    return params, batch, {k: jnp.asarray(v.numpy()) for k, v in
                           batch.items()}


def _jax_noise(cfg, rng):
    """The uniforms lav_tpu's bev_planner_forward draws from `rng`."""
    N, K = cfg.max_objs - 1, cfg.max_num_cars
    r_sel, r_jit = jax.random.split(rng)
    kl, ko = jax.random.split(r_jit)
    u = jax.random.uniform
    d = dict(scores=u(r_sel, (B, N)), loc=u(kl, (B, K, 2)),
             ori=u(ko, (B, K)))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _ref_step(cfg, v2, batch_j):
    """lav_tpu's make_bev_train_step body, jitted, with the gradients."""
    loss_terms = j_loss_fn(cfg, v2=v2)
    opt = optax.adam(LR)

    @jax.jit
    def step(params, opt_state, rng):
        def loss_fn(p):
            out, state = j_forward(
                p, cfg, batch_j["bev"], batch_j["ego_locs"], batch_j["locs"],
                batch_j["oris"], batch_j["nxps"], batch_j["typs"], rng,
                train=True)
            loss, metrics = loss_terms(out, batch_j, OTHER_WEIGHT)
            return loss, (state, metrics)

        (_, (state, metrics)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = j_merge_bn_state(optax.apply_updates(params, updates),
                                  state)
        return metrics, grads, params, opt_state

    return step, opt


def _as_port(tcfg, tree):
    return load_jax_params(BEVPlanner(tcfg), _tree(tree))


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_bev_step_matches_lav_tpu(v2):
    cfg, tcfg = _cfgs(v2)
    params, batch, batch_j = _setup(tcfg)
    ref_step, opt = _ref_step(cfg, v2, batch_j)
    models = _as_port(tcfg, params)
    optimizer = adam(models, LR)
    step = TP.make_bev_train_step(tcfg, v2=v2)
    opt_state = opt.init(params)
    close = {}
    steps = ((1, 1e-7), (2, STEP2_UPD_TOL)) if v2 else ((1, 1e-7),)
    for it, upd_tol in steps:
        rng = jax.random.key(it)
        ref_metrics, ref_grads, params, opt_state = ref_step(
            params, opt_state, rng)
        metrics = step(models, optimizer, batch,
                       noise=_jax_noise(cfg, rng), other_weight=OTHER_WEIGHT)
        tag = f"privileged.bev_{'v2' if v2 else 'v1'}_step{it}"
        check_grads(tag, models, metrics, ref_metrics,
                    _as_port(tcfg, ref_grads), TOL)
        check_update(tag, models, _as_port(tcfg, params),
                     _as_port(tcfg, ref_grads), upd_tol, close, LR,
                     STAT_TOL)
        # step 2 starts from lav_tpu's params (see the module note)
        load_jax_params(models, _tree(params))


def test_bev_planner_forward_eval_matches_lav_tpu():
    """Eval mode: no jitter, BN on running statistics; the car pick
    still takes the scores."""
    cfg, tcfg = _cfgs(False)
    params, batch, batch_j = _setup(tcfg)
    rng = jax.random.key(5)
    ref, _ = j_forward(params, cfg, batch_j["bev"], batch_j["ego_locs"],
                       batch_j["locs"], batch_j["oris"], batch_j["nxps"],
                       batch_j["typs"], rng, train=False)
    planner = _as_port(tcfg, params)
    assert not planner.training
    with torch.no_grad():
        out = bev_planner_forward(
            planner, tcfg, batch["bev"], batch["ego_locs"], batch["locs"],
            batch["oris"], batch["nxps"], batch["typs"],
            _jax_noise(cfg, rng))
    for name, got in out._asdict().items():
        want = np.asarray(getattr(ref, name))
        if name == "car_valid":
            assert np.array_equal(got.numpy(), want)
        else:
            assert_close(f"privileged.bev_forward_eval.{name}", got, want,
                         atol=EVAL_ATOL)
    assert out.car_valid.any() and not out.car_valid.all()


def test_bev_planner_infer_reproduces_golden():
    """tests/golden/bev_planner_infer.npz, made as tests/test_golden.py's
    test_golden_bev_planner makes it."""
    cfg, tcfg = _cfgs(False)
    params = bev_planner_init(jax.random.key(12), cfg)
    bev = np.random.default_rng(8).uniform(
        0, 1, (1, cfg.ny, cfg.nx, 5)).astype(np.float32)
    nxps = np.asarray([[4.0, 1.0]], np.float32)
    planner = _as_port(tcfg, params)
    with torch.no_grad():
        plan, cast_locs, cmds = bev_planner_infer(
            planner, tcfg, torch.from_numpy(bev), torch.from_numpy(nxps))
    golden = np.load(GOLDEN)
    for name, got in (("plan", plan[0, -1]), ("cast", cast_locs[0]),
                      ("cmds", cmds[0])):
        assert_close(f"privileged.bev_infer_golden.{name}", got,
                     golden[name], atol=1e-4, rtol=1e-3)
    ref = j_infer(params, cfg, jnp.asarray(bev), jnp.asarray(nxps))
    for name, got, want in zip(("plan", "cast", "cmds"),
                               (plan, cast_locs, cmds), ref):
        assert_close(f"privileged.bev_infer.{name}", got, np.asarray(want),
                     atol=EVAL_ATOL)


def test_step_lr_matches_optax_staircase():
    """Ten Adam updates of one parameter under `step_lr` against
    optax.adam(exponential_decay(staircase=True)): the learning rate of
    each update and the parameter after it."""
    base, spe, every, gamma = 1e-2, 2, 2, 0.5
    sched = optax.exponential_decay(base, transition_steps=spe * every,
                                    decay_rate=gamma, staircase=True)
    opt = optax.adam(sched)
    w_j = jnp.asarray([1.0, -2.0])
    state = opt.init(w_j)
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    optimizer = adam(torch.nn.ParameterList([w]), lr=123.0)
    lr_sched = TP.step_lr(optimizer, base, spe, every, gamma)
    for n in range(10):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(sched(n)), rel=1e-6), n
        g = np.asarray([0.3 + n, -0.7 * n], np.float32)
        upd, state = opt.update(jnp.asarray(g), state, w_j)
        w_j = optax.apply_updates(w_j, upd)
        w.grad = torch.from_numpy(g)
        optimizer.step()
        lr_sched.step()
        assert_close("privileged.step_lr.param", w, np.asarray(w_j),
                     atol=1e-6, rtol=1e-5)


def test_setups_raise_without_a_card():
    """The three setups default to the card and refuse to run without
    one; device="cpu" builds each step."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    for setup in (TP.bev_setup, TP.seg_setup, TP.bra_setup):
        with pytest.raises(RuntimeError, match="CUDA"):
            setup()
    _, tcfg = _cfgs(True)
    step, models, optimizer, batch, gen, _ = TP.bev_setup(
        2, device="cpu", cfg=tcfg)
    metrics = step(models, optimizer, batch, gen)
    assert set(metrics) == {"loss", "plan_loss", "ego_cast_loss",
                            "other_cast_loss", "cmd_loss", "grad_norm"}
    assert all(torch.isfinite(v) for v in metrics.values())
