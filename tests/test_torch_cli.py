"""The port's training CLI (lav_tpu_torch.train.cli) against lav_tpu's on
the CPU, at tiny_config (crops of 32: PyTorch's CPU bf16 conv misbehaves
on the crop ResNet's 1x1 maps at crops of 16, tests/test_torch_train_bf16)
on a synthetic `.lavpack` data dir of two episodes (8 samples a stage,
images 128x32 so that the brake net's telephoto keeps 32 rows below its
96-row crop).

  * `load_config` of configs/v1.yaml and v2.yaml: field-equal to lav_tpu's.
  * `MultiSteps` + `step_lr` against optax.MultiSteps(optax.adam(lav_tpu's
    step_lr)) on the same gradients, with --grad-accum 1 and 2 and a
    resume in the middle of an accumulation: the learning rate of every
    update equals optax's schedule at its update count (exactly, in
    f32: the decay is a power of 2), the partial gradient mean equals optax's
    acc_grads exactly (both take acc + (g - acc) / (n + 1) in f32), and
    the params stay within PARAM_ATOL of optax's (torch's and optax's
    Adam round the update differently; measured <= 6e-8 of params ~1).
  * Every stage runs through `main([..., "--device", "cpu"])`: finite
    metrics logged to metrics.jsonl every step, a checkpoint every epoch.
  * (tests/test_torch_cli_parity.py) Step 1 of the bev (v2) and full
    (v2) stages through the CLI's own loop against lav_tpu's CLI pieces (its dataset, loader, step_lr,
    optax.adam, step and the key the loop splits from --seed), from the
    same params (the port's initialisers, lav_tpu's tree through
    `torch_parity.jax_tree`) with lav_tpu's draws (the helpers of
    tests/test_torch_privileged.py and tests/test_torch_train.py): the
    first batch equal; the loss terms, grad_norm and each gradient leaf
    (lav_tpu's, kept by an optax stage chained before its Adam) with
    `torch_parity.check_grads`: the loss terms to rtol 1e-4 and grad_norm
    to rtol 1e-3, the tolerances of those files.  The leaves are held
    wider than there, as the loader's samples (binary BEV maps, 0/1)
    condition the steps worse than those files' random batches: a 1e-5
    change of the BEV, the size of lav_tpu's and the port's crops'
    difference, moves the port's own bev leaves by up to 1.1% (6.1e-3 of
    grad_norm in all), and a 1e-6 change of the points moves its full
    leaves by up to 1.1% and 3.6e-3 of grad_norm in all.  So: bev each
    leaf in L2 to 1e-2 of its norm + 1e-6 grad_norm [measured 2.8e-3,
    the crop ResNet's conv1; the rest <= 4.2e-5], all to 3e-3 of
    grad_norm [1.07e-3]; full each leaf to 2e-2 (test_torch_train's)
    [1.1e-2] and all to 1e-2 [3.6e-3].  The update is held to 1e-7 where
    the two gradients agree, Adam's bound elsewhere, and the BN
    statistics to 1e-5 (`torch_parity.check_update`).  The full stage's
    teacher comes from `bev_model_dir`, exactly.
  * (the same file) A resumed run does what lav_tpu's does: params, optimizer state and
    position restored; the loader's shuffle and jitter and the noise
    start again from --seed (its batches equal lav_tpu's fresh loader's
    first epoch); the other_weight ramp and the schedule go on from the
    restored iteration and update count.
"""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from lav_tpu import config as JC
from lav_tpu.train import privileged as JP
from lav_tpu_torch import config as TC
from lav_tpu_torch.data.lavpack import convert_episode
from lav_tpu_torch.data.store import make_synthetic_episode
from lav_tpu_torch.models.planner import BEVPlanner
from lav_tpu_torch.train import checkpoints as CK
from lav_tpu_torch.train import cli, paint
from lav_tpu_torch.train.distill import MultiSteps, adam
from lav_tpu_torch.train.privileged import step_lr
from tests.torch_parity import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BW = [5, 5, 5, 1, 1, 1]          # v2_config().branch_weights
LR = 3e-4
B = 8                            # the parity steps: one step an epoch
PARAM_ATOL = 1e-7
STAT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump({f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)}, f)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A .lavpack data dir (painted episodes) and tiny v1 / v2 YAMLs, a
    BEV planner state_dict for the full stage's teacher."""
    root = tmp_path_factory.mktemp("cli")
    (root / "data").mkdir()
    for s in (0, 1):
        ep = make_synthetic_episode(n_frames=8, n_lidar=96, img_hw=(128, 32),
                                    bev_hw=(32, 32), seed=s,
                                    with_painted=True, n_seg=4)
        convert_episode(ep, str(root / "data" / f"ep{s}.lavpack"))
    kw = dict(crop_size=32, data_dir=str(root / "data"))
    v2 = dict(kw, num_frame_stack=2, branch_weights=BW)
    teacher = CK.save_checkpoint(
        str(root / "teacher.th"),
        BEVPlanner(TC.tiny_config(**v2),
                   torch.Generator().manual_seed(7)).state_dict())
    return dict(
        root=root, teacher=teacher,
        v1=_write_yaml(root / "v1.yaml", TC.tiny_config(**kw)),
        v2=_write_yaml(root / "v2.yaml", TC.tiny_config(**v2)),
        v2_teacher=_write_yaml(root / "v2t.yaml", TC.tiny_config(
            **v2, bev_model_dir=teacher)))


def _args(data, stage, *extra, cfg="v1", save="ck"):
    return [stage, "--config-path", data[cfg], "--device", "cpu",
            "--save-dir", str(data["root"] / save), *extra]


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_load_config_matches_lav_tpu(name):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    want = dataclasses.asdict(JC.load_config(path))
    got = dataclasses.asdict(TC.load_config(path))
    assert got == want and got["max_lidar_points"] == (
        120000 if name == "v2" else 40000)


class _Leaf(torch.nn.Module):
    def __init__(self, p0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))


def _port_opt(p0, k):
    m = _Leaf(p0)
    opt = adam(m, LR)
    ms = MultiSteps(opt, k, step_lr(opt, LR, 2, 1))
    lrs = []
    inner = opt.step

    def step(*a, **kw):
        lrs.append(opt.param_groups[0]["lr"])
        return inner(*a, **kw)

    opt.step = step
    return m, ms, lrs


@pytest.mark.parametrize("k", [1, 2])
def test_schedule_and_accumulation_match_optax(k, tmp_path):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    grads = rng.normal(size=(12, 3, 4)).astype(np.float32)
    sched = JP.step_lr(LR, 2, 1)            # halved every 2 updates
    jopt = optax.MultiSteps(optax.adam(sched), every_k_schedule=k)
    jp = jnp.asarray(p0)
    js = jopt.init(jp)
    m, ms, lrs = _port_opt(p0, k)
    seen = []
    for i, g in enumerate(grads):
        if i == 5:      # resume from a snapshot: mid-accumulation for k = 2
            path = CK.save_checkpoint(str(tmp_path / "s"),
                                      CK.snapshot(m, ms, 0, i))
            m2, ms2, lrs2 = _port_opt(rng.normal(size=p0.shape).astype(
                np.float32), k)
            CK.load_checkpoint(path, m2, ms2)
            assert ms2.mini_step == ms.mini_step == (1 if k == 2 else 0)
            seen, (m, ms, lrs) = seen + lrs, (m2, ms2, lrs2)
        u, js = jopt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        m.w.grad = torch.from_numpy(g.copy())
        applied = ms.step()
        assert applied == ((i + 1) % k == 0)
        if not applied:
            assert torch.equal(ms.acc[0], torch.from_numpy(
                np.array(js.acc_grads)))
        assert_close(f"cli.multisteps_k{k}", m.w, jp, atol=PARAM_ATOL)
    seen += lrs
    n_updates = len(grads) // k
    assert [np.float32(x) for x in seen] == [sched(u) for u in
                                             range(n_updates)]
    assert len(set(seen)) > 2


STAGE_RUNS = {
    "bev": ("bev", "v1", []),
    "bev_v2_accum": ("bev", "v2", ["--v2", "--grad-accum", "2"]),
    "seg": ("seg", "v1", []),
    "bra": ("bra", "v1", []),
    "bra_v2": ("bra", "v2", ["--v2"]),
    "full": ("full", "v1", []),
    "full_v2": ("full", "v2_teacher", ["--v2"]),
    "full_v2_perceive_only": ("full", "v2", ["--v2", "--perceive-only"]),
    "full_v2_motion_only": ("full", "v2", ["--v2", "--motion-only"]),
    "full_v2_bf16_remat": ("full", "v2", ["--v2", "--dtype", "bfloat16",
                                          "--remat"]),
}


@pytest.mark.parametrize("run", STAGE_RUNS)
def test_every_stage_runs_through_main(run, data):
    stage, cfg, extra = STAGE_RUNS[run]
    out = cli.main(_args(data, stage, "--num-epoch", "2", "--batch-size",
                         "4", "--num-per-log", "1", *extra, cfg=cfg,
                         save=run))
    per_epoch = len(out.stage.dataset) // 4
    assert per_epoch >= 2 and out.it == 2 * per_epoch and out.epoch == 2
    assert len(out.step_ms) == len(out.wait_ms) == out.it
    save = data["root"] / run / stage
    recs = [json.loads(s) for s in open(save / "metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(out.it))
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               for r in recs)
    for e in (1, 2):
        snap = torch.load(save / f"{stage}_{e}")
        assert (snap["epoch"], snap["it"]) == (e, e * per_epoch)
    want = {"bev": "float32", "bras": "int32", "lidar": "float32",
            "lidar_valid": "bool", "rgb": "float32", "sem": "int32"}
    for k, v in out.batch_dtypes.items():
        assert str(v) == "torch." + want.get(k, str(v).split(".")[1]), k
        assert v not in (torch.float64, torch.int64), k
    if run == "full_v2":
        teacher = torch.load(data["teacher"])
        got = out.stage.models["uniplanner"].bev_planner.state_dict()
        assert all(torch.equal(got[k], teacher[k]) for k in teacher)


def test_refusals(data):
    with pytest.raises(ValueError, match="1 ranks do not factor into 2"):
        cli.main(_args(data, "seg", "--dcn-slices", "2"))
    with pytest.raises(RuntimeError, match="ZERO steps"):
        cli.main(_args(data, "bra", "--batch-size", "64", "--num-epoch",
                       "1"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(_args(data, "seg")[:-4] + ["--device", "cuda"])
    seg = cli.main(_args(data, "seg", "--num-epoch", "1", "--batch-size",
                         "8", save="paint"))
    ck = str(data["root"] / "paint" / "seg" / "seg_1")
    # a .lavpack store takes no commit, as lav_tpu's (ROADMAP section C)
    with pytest.raises(AttributeError, match="put"):
        paint.main(["--config-path", data["v1"], "--seg-checkpoint", ck,
                    "--device", "cpu"])
    assert seg.it == len(seg.stage.dataset) // 8
