"""Step 1 of the port's bev and full stages through the CLI's own loop,
and a resumed run, against lav_tpu on the CPU: the data dir, the YAMLs
and the tolerances of tests/test_torch_cli.py, whose note says what each
check holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lav_tpu import config as JC
from lav_tpu.data import datasets as JD
from lav_tpu.data import loader as JL
from lav_tpu.train import distill as JT
from lav_tpu.train import privileged as JP
from lav_tpu_torch import config as TC
from lav_tpu_torch.data.loader import DataLoader
from lav_tpu_torch.models.planner import BEVPlanner
from lav_tpu_torch.train import cli
from lav_tpu_torch.train import privileged as TPV
from lav_tpu_torch.train.distill import distill_models
from lav_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_cli import (  # noqa: F401 (data: the fixture)
    B, LR, STAT_TOL, _args, data,
)
from tests.test_torch_privileged import TOL as BEV_TOL
from tests.test_torch_privileged import _jax_noise as _bev_noise
from tests.test_torch_train import (
    FLOOR, METRIC_RTOL, SURE_G, SURE_REL, V2_GRAD_TOL,
)
from tests.test_torch_train import _jax_noise as _full_noise
from tests.torch_parity import check_grads, check_update, jax_tree

# The loss terms and grad_norm at those files' tolerances; the leaves
# wider, as this data conditions the steps worse than their random batches
# (tests/test_torch_cli.py's note has the measurements)
BEV_TOL = dict(BEV_TOL, leaf=1e-2, all=3e-3)
FULL_TOL = dict(zip(("grad_norm", "leaf", "all"), V2_GRAD_TOL),
                metric=METRIC_RTOL, floor=FLOOR, all=1e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(models):
    return jax.tree.map(jnp.asarray, jax_tree(models))


def _keep_grads():
    """An optax stage that passes the gradients on and keeps them in its
    state, so that lav_tpu's own step hands them back."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def _check_step1(tag, stage, seen, jbatch, jm, new_params, jgrads, make,
                 tol):
    """The first batch equal; the loss terms, grad_norm and each gradient
    leaf to `tol` (torch_parity.check_grads); the update to 1e-7 where the
    two gradients agree, Adam's bound elsewhere, and the BN statistics to
    STAT_TOL (torch_parity.check_update)."""
    assert sorted(seen["batch"]) == sorted(jbatch)
    for k, v in jbatch.items():
        assert np.array_equal(seen["batch"][k].numpy(), np.asarray(v)), k
    want_g = load_jax_params(make(stage.cfg), jax.tree.map(np.asarray, jgrads))
    check_grads(tag, stage.models, seen["metrics"], jm, want_g, tol)
    want = load_jax_params(make(stage.cfg),
                           jax.tree.map(np.asarray, new_params))
    check_update(tag, stage.models, want, want_g, 1e-7, {}, LR, STAT_TOL,
                 SURE_G, SURE_REL)


def _run_step1(data, stage_name, cfg, extra, noise):
    """The port's CLI loop for one epoch of one step, taking `noise` in
    step 1; returns (stage, what step 1 saw)."""
    args = cli.parser().parse_args(_args(
        data, stage_name, "--v2", "--batch-size", str(B), "--num-epoch",
        "1", *extra, cfg=cfg, save=f"step1_{stage_name}"))
    stage = cli.SETUPS[stage_name](args)
    params = _jax_params(stage.models)
    seen = {}

    def run(batch, it):
        seen["batch"] = batch
        seen["metrics"] = stage.run(batch, it, noise=noise)
        return seen["metrics"]

    out = cli.train(stage._replace(run=run), args)
    assert out.it == 1
    return stage, seen, params, args


def _lav_tpu_first(cfg_path, name, seed):
    jcfg = JC.load_config(cfg_path)
    jds = JD.get_dataset(name, jcfg)
    return jcfg, jds, next(iter(JL.DataLoader(jds, B, seed=seed)))


def test_bev_stage_step1_matches_lav_tpu(data):
    jcfg = JC.load_config(data["v2"])
    rng, sub = jax.random.split(jax.random.key(2021))
    stage, seen, params, args = _run_step1(data, "bev", "v2", [],
                                           _bev_noise(jcfg, sub))
    jcfg, jds, jbatch = _lav_tpu_first(data["v2"], "temporal_bev",
                                       args.seed)
    opt = optax.chain(_keep_grads(), optax.adam(
        JP.step_lr(LR, max(len(jds) // 256, 1), 32)))
    step = jax.jit(JP.make_bev_train_step(jcfg, opt, v2=True))
    new_params, opt_state, jm = step(params, opt.init(params), jbatch, sub,
                                     cli._other_weight_ramp(0))
    _check_step1("cli.bev_step1", stage, seen, jbatch, jm, new_params,
                 opt_state[0], BEVPlanner, BEV_TOL)


def test_full_stage_step1_matches_lav_tpu(data):
    rng, sub = jax.random.split(jax.random.key(2021))
    stage, seen, params, args = _run_step1(
        data, "full", "v2_teacher", [], _full_noise(sub, B))
    teacher = torch.load(data["teacher"])
    got = stage.models["uniplanner"].bev_planner.state_dict()
    assert all(torch.equal(got[k], teacher[k]) for k in teacher)
    jcfg, jds, jbatch = _lav_tpu_first(data["v2"], "temporal_lidar_painted",
                                       args.seed)
    opt = optax.chain(_keep_grads(), optax.adam(
        JP.step_lr(LR, max(len(jds) // 32, 1), 16)))
    step = jax.jit(JT.make_full_train_step(jcfg, opt, v2=True, mode="full"))
    new_params, opt_state, jm = step(params, opt.init(params), jbatch, sub)
    _check_step1("cli.full_step1", stage, seen, jbatch, jm, new_params,
                 opt_state[0], distill_models, FULL_TOL)


def test_resume_restarts_the_draws_as_lav_tpu(data, monkeypatch):
    base = ["--v2", "--batch-size", "4"]
    first = cli.main(_args(data, "bev", *base, "--num-epoch", "1",
                           cfg="v2", save="resume"))
    ck = str(data["root"] / "resume" / "bev" / "bev_1")
    assert first.it == 2
    noises, ramps = [], []
    draw, ramp = TPV.draw_bev_noise, cli._other_weight_ramp

    def draw_spy(*a, **kw):
        noises.append(draw(*a, **kw))
        return noises[-1]

    monkeypatch.setattr(TPV, "draw_bev_noise", draw_spy)
    monkeypatch.setattr(cli, "_other_weight_ramp",
                        lambda it: ramps.append(it) or ramp(it))
    args = cli.parser().parse_args(_args(
        data, "bev", *base, "--num-epoch", "2", "--resume", ck, cfg="v2",
        save="resume2"))
    stage = cli.SETUPS["bev"](args)
    snap = torch.load(ck)
    lrs, batches = [], []
    inner = stage.optimizer.optimizer.step

    def opt_step(*a, **kw):
        lrs.append(stage.optimizer.param_groups[0]["lr"])
        return inner(*a, **kw)

    stage.optimizer.optimizer.step = opt_step

    def run(batch, it):
        if not batches:     # restored exactly, before its first step
            got = stage.models.state_dict()
            assert all(torch.equal(got[k], v) for k, v in
                       snap["params"].items())
            assert stage.optimizer.scheduler.last_epoch == 2
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return stage.run(batch, it)

    out = cli.train(stage._replace(run=run), args)
    assert (out.epoch, out.it) == (2, 4) and ramps == [2, 3]
    # the schedule goes on from update 2; the draws start again
    sched = JP.step_lr(LR, max(len(stage.dataset) // 256, 1), 32)
    assert [np.float32(x) for x in lrs] == [sched(u) for u in (2, 3)]
    fresh = torch.Generator().manual_seed(2021)
    assert len(noises) == 2
    for got in noises:
        want = draw(fresh, *got["scores"].shape, got["loc"].shape[1])
        assert all(torch.equal(got[k], want[k]) for k in want)
    # the batches are lav_tpu's fresh loader's first epoch
    jds = JD.get_dataset("temporal_bev", JC.load_config(data["v2"]))
    jbatches = list(JL.DataLoader(jds, 4, seed=2021)._host_batches())
    assert len(jbatches) == len(batches) == 2
    for want, got in zip(jbatches, batches):
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    # and the port's own fresh loader gives the same
    tds = cli.get_dataset("temporal_bev", TC.load_config(data["v2"]))
    for want, got in zip(DataLoader(tds, 4, seed=2021), batches):
        assert all(np.array_equal(got[k], want[k].numpy()) for k in want)
