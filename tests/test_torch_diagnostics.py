"""The training diagnostics (`lav_tpu_torch/train/diagnostics.py`,
`utils/figures.py`) against lav_tpu's on the CPU.

* `make_lidar_probe` on sample 0 of a distillation batch, from lav_tpu's
  params converted by `load_jax_params` (the heads' output biases raised
  so that peaks pass the score and size filters): the detections of both
  classes
  slot by slot (columns, rows and valid exact; score, box and orientation
  at atol 1e-4), the predicted BEV and the plans, casts and other cars at
  atol 1e-4 / rtol 1e-3 (the agent tests' f32 tolerance); models in train
  mode come back in train mode;
* `make_bev_probe` on a BEV sample: plan, casts and command scores at the
  same tolerance;
* every panel, drawn from the probes' outputs, equals lav_tpu's panel of
  the same inputs pixel for pixel (uint8 RGB images), and importing the
  figures module does not import matplotlib.
"""

import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.train import diagnostics as JD
from lav_tpu.utils import figures as JF
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.models.planner import BEVPlanner
from lav_tpu_torch.train import diagnostics as TD
from lav_tpu_torch.train.distill import make_batch
from lav_tpu_torch.utils import figures as TF
from tests.test_agent import _params
from tests.test_torch_agent import _models
from tests.torch_parity import assert_close, jax_tree

TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def probes():
    cfg, tcfg = tiny_config(), t_tiny_config()
    params = jax.tree.map(np.asarray, _params(cfg))
    # heads biased so that peaks pass the score (0.2) and size filters
    lid = params["lidar_model"]
    lid["center_head"]["up"]["b"] = lid["center_head"]["up"]["b"] + 2.0
    lid["box_head"]["up"]["b"] = lid["box_head"]["up"]["b"] + 3.0
    models = _models(tcfg, params, 1)
    batch = make_batch(tcfg, 2, 256, seed=3, device="cpu")
    lidar, valid = batch["lidar"][0], batch["lidar_valid"][0]
    cmd, nxp = torch.tensor(2, dtype=torch.int32), torch.tensor([1.5, -4.0])
    models.lidar_model.train()
    got = TD.make_lidar_probe(tcfg)(models, lidar, valid, cmd, nxp)
    assert models.lidar_model.training and not models.uniplanner.training
    want = JD.make_lidar_probe(cfg)(
        {k: params[k] for k in ("lidar_model", "uniplanner")},
        jnp.asarray(lidar.numpy()), jnp.asarray(valid.numpy()),
        jnp.int32(2), jnp.asarray(nxp.numpy()))
    planner = BEVPlanner(tcfg, torch.Generator().manual_seed(6))
    bev = batch["bev"][1]
    got_bev = TD.make_bev_probe(tcfg)(planner, bev, nxp)
    want_bev = JD.make_bev_probe(cfg)(
        jax.tree.map(jnp.asarray, jax_tree(planner)),
        jnp.asarray(bev.numpy()), jnp.asarray(nxp.numpy()))
    return got, want, got_bev, want_bev, bev, nxp


def test_lidar_probe_matches_lav_tpu(probes):
    got, want = probes[:2]
    for f, w in want["dets"].items():
        g = got["dets"][f]
        assert g.shape == w.shape, f
        if f in ("x", "y", "valid"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f)
        else:
            assert_close(f"diag.dets.{f}", g, w, atol=1e-4)
    assert got["dets"]["valid"].any()
    for k in ("pred_bev", "ego_plan_locs", "other_cast_locs",
              "other_cast_cmds"):
        assert_close(f"diag.{k}", got[k], want[k], **TOL)
    np.testing.assert_array_equal(got["other_valid"].numpy(),
                                  np.asarray(want["other_valid"]))


def test_bev_probe_matches_lav_tpu(probes):
    got, want = probes[2:4]
    for k, w in want.items():
        assert_close(f"diag.bev.{k}", got[k], w, **TOL)


def _same_panel(a, b):
    assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 3
    np.testing.assert_array_equal(a, b)


def test_panels_match_lav_tpu(probes):
    got, _, got_bev, _, bev, nxp = probes
    bev_mean = bev.mean(-1).numpy()
    _same_panel(TF.bev_panel(bev_mean,
                             ego_plan_locs=got_bev["ego_plan_locs"].numpy(),
                             ego_cast_locs=got_bev["ego_cast_locs"].numpy(),
                             nxp=nxp.numpy(), pixels_per_meter=2.0,
                             center=(16.0, 28.0)),
                JF.bev_panel(bev_mean,
                             ego_plan_locs=got_bev["ego_plan_locs"].numpy(),
                             ego_cast_locs=got_bev["ego_cast_locs"].numpy(),
                             nxp=nxp.numpy(), pixels_per_meter=2.0,
                             center=(16.0, 28.0)))
    dets = {k: v[1].numpy() for k, v in got["dets"].items()}
    pred = got["pred_bev"].mean(0).numpy()
    _same_panel(TF.det_panel(pred, dets, gt_dets=dets),
                JF.det_panel(pred, dets, gt_dets=dets))
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 255, (32, 48, 3))
    sem = rng.integers(0, 5, (32, 48))
    _same_panel(TF.seg_panel(rgb, sem, sem[::-1]),
                JF.seg_panel(rgb, sem, sem[::-1]))
    _same_panel(TF.bra_panel(rgb, rgb[:16], 1.0, 0.25),
                JF.bra_panel(rgb, rgb[:16], 1.0, 0.25))
    counts = rng.integers(0, 900, 64)
    _same_panel(TF.point_histogram_panel(counts),
                JF.point_histogram_panel(counts))


def test_figures_import_without_matplotlib():
    code = ("import sys, lav_tpu_torch.utils.figures, "
            "lav_tpu_torch.train.diagnostics; "
            "sys.exit('matplotlib' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
