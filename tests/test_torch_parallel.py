"""Data-parallel training (`lav_tpu_torch/parallel/`) on the CPU, over
gloo, each rank a spawned process joined with a timeout of its own
(`parallel.dryrun.spawn`: a rank that hangs fails the test).

* one rank under the process group runs the one-process step bit for bit:
  the distillation step's losses, grad_norm, every gradient, every
  BatchNorm running statistic and every parameter after 2 Adam steps;
* two ranks against one process on the same global batch (8 items), the
  distillation step and the v2 BEV step with its train-mode BatchNorm, at
  `dryrun.RTOL`: the first step's loss (1e-5), grad_norm (1e-4) and
  gradients (every leaf's difference, in L2, within 1e-3 of grad_norm),
  BatchNorm's running statistics after it (1e-5, in L2), the second
  step's loss (1e-4), and both ranks' parameters and buffers equal bit for
  bit.  Planted in a copy, rank-local BN statistics, rank-local running
  statistics, per-rank ratios of means and a missing gradient all-reduce
  each exceed one of these by 680x or more on the CPU (PERF.md).  Why
  the second step is held by its loss alone: `dryrun`'s note (train-mode BatchNorm over tiny_config's small maps amplifies the
  ranks' other summation order; measured there, 1e-4 of a leaf in step 1
  and 1-7% in step 2, and a 3% grad_norm after Adam's first update);
* the CLI's `full` stage on two ranks logs the losses it logs on one
  (every loss term of every step within 1e-4, with --lr 0);
* a batch size that does not divide over the ranks raises lav_tpu's
  message (`lav_tpu/train/cli.py:102-107`), and so does a world size
  that --dcn-slices does not divide.
"""

import dataclasses

import pytest
import torch
import yaml

from lav_tpu_torch import config as TC
from lav_tpu_torch.data.lavpack import convert_episode
from lav_tpu_torch.data.store import make_synthetic_episode
from lav_tpu_torch.parallel import DataMesh
from lav_tpu_torch.parallel import dryrun as D
from lav_tpu_torch.train import cli

TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_one_rank_is_the_one_process_step_bit_for_bit():
    want = D.distill_case(None, device="cpu")
    got, = D.spawn("distill", 1, device="cpu", timeout=TIMEOUT)
    assert got["metrics"] == want["metrics"]
    for key in ("grads", "buffers", "params"):
        tree_g = got[key] if key != "params" else [got[key]]
        tree_w = want[key] if key != "params" else [want[key]]
        for g, w in zip(tree_g, tree_w):
            assert g.keys() == w.keys()
            assert all(torch.equal(g[n], w[n]) for n in w), key


@pytest.mark.parametrize("case", ["distill", "bev"])
def test_two_ranks_match_one_process(case):
    res = D.dryrun(2, (case,), device="cpu", timeout=TIMEOUT)[case]
    assert len(res) == 2 and res[0] == res[1]


def _data(root):
    (root / "data").mkdir()
    for s in (0, 1):
        ep = make_synthetic_episode(n_frames=8, n_lidar=96, img_hw=(128, 32),
                                    bev_hw=(32, 32), seed=s,
                                    with_painted=True, n_seg=4)
        convert_episode(ep, str(root / "data" / f"ep{s}.lavpack"))
    cfg = TC.tiny_config(crop_size=32, data_dir=str(root / "data"),
                         num_frame_stack=2, branch_weights=[5, 5, 5, 1, 1, 1])
    path = root / "v2.yaml"
    with open(path, "w") as f:
        yaml.safe_dump({k.name: getattr(cfg, k.name)
                        for k in dataclasses.fields(cfg)}, f)
    return str(path)


def _argv(cfg, save, *extra):
    return ["full", "--config-path", cfg, "--v2", "--device", "cpu",
            "--batch-size", "4", "--num-epoch", "2", "--num-per-log", "1",
            "--save-dir", save, *extra]


def test_cli_full_stage_on_two_ranks_logs_the_one_rank_losses(tmp_path):
    """With --lr 0 every step's losses depend on the loader's batches, the
    noise draws and the reductions, not on Adam's amplification of the
    first update (see the module note): each logged loss term within 1e-4
    over 2 epochs of 2 steps."""
    cfg = _data(tmp_path)
    extra = ("--lr", "0")
    want = D.cli_case(None, _argv(cfg, str(tmp_path / "one"), *extra))
    got = D.spawn("cli", 2, device="cpu", timeout=TIMEOUT,
                  argv=_argv(cfg, str(tmp_path / "two"), *extra))
    assert got[1] is None and len(got[0]) == len(want) == 4
    for g, w in zip(got[0], want):
        assert g["step"] == w["step"]
        for k in ("loss", "hm_loss", "box_loss", "seg_loss", "plan_loss",
                  "ego_cast_loss", "other_cast_loss", "cmd_loss"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (g["step"], k)


def test_refusals(tmp_path):
    cfg = _data(tmp_path)
    args = cli.parser().parse_args(_argv(cfg, str(tmp_path / "r"),
                                         "--batch-size", "3"))
    mesh = DataMesh(0, 2, 0, torch.device("cpu"), "gloo")
    # the check comes before any collective: no process group is needed
    want = ("batch size 3 is not divisible by the 2-device data mesh; pick "
            "a multiple of 2 (e.g. --batch-size 4)")
    with pytest.raises(ValueError) as err:
        cli.train(cli.SETUPS["full"](args), args, mesh)
    assert str(err.value) == want
    args.batch_size, args.dcn_slices = 4, 3
    with pytest.raises(ValueError, match="2 ranks do not factor into 3"):
        cli.train(cli.SETUPS["full"](args), args, mesh)
