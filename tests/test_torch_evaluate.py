"""The port's replay evaluator (lav_tpu_torch.agent.evaluate, env, demo)
against lav_tpu's on the CPU, at tiny_config.

Both packages build the same synthetic episodes from the same seeds, and
the port's models hold lav_tpu's `build_params` weights (converted by
`utils/weights.py::load_jax_params`; with `eval_priors`, the port's
`apply_eval_priors` on lav_tpu's plain weights equals lav_tpu's own).
Counts must be equal; the expert plan L2, the steer correlation and the
control sums within 1e-4 relative (the agent's tolerance, summed over
ticks); `make_results_json` gives lav_tpu's dict on the same records.
"""

import json
import math
import struct

import jax
import numpy as np
import pytest
import torch

from lav_tpu.agent import evaluate as JV
from lav_tpu.agent.agent import build_agent as j_build_agent
from lav_tpu.agent.demo import build_params as j_build_params
from lav_tpu.agent.env import ReplayEnv as JReplayEnv
from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu.data.store import make_synthetic_episode as j_episode
from lav_tpu_torch.agent import demo, evaluate
from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.agent.env import ReplayEnv, obs_to_tensors
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.data.store import make_synthetic_episode
from lav_tpu_torch.utils.profiling import StepTimer, trace
from lav_tpu_torch.utils.video import VideoRecorder
from lav_tpu_torch.utils.weights import load_jax_params

JCFG, TCFG = j_tiny_config(), tiny_config()
IMG_HW = (32, 32)
MAX_PTS = 256
TICKS = 8
REL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(params, cfg=TCFG):
    models = AgentModels(cfg, brake_version=2 if cfg.num_frame_stack else 1)
    return load_jax_params(models, jax.tree.map(np.asarray, params)).eval()


def avi_frames(path) -> int:
    """dwTotalFrames of an AVI's main header."""
    data = open(path, "rb").read()
    at = data.index(b"avih") + 8
    return struct.unpack_from("<14I", data, at)[4]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    n = TICKS + JCFG.num_plan + 1
    params = j_build_params(JCFG)
    init_j, step_j = j_build_agent(JCFG, max_points=MAX_PTS, rgb_hw=IMG_HW)
    jrec = JV.evaluate_episode(
        JCFG, params, JReplayEnv(j_episode(n_frames=n, n_lidar=MAX_PTS,
                                           img_hw=IMG_HW, seed=0,
                                           bev_hw=(JCFG.ny, JCFG.nx)),
                                 JCFG, max_points=MAX_PTS),
        jax.jit(step_j), init_j, TICKS)
    init_t, step_t = build_agent(TCFG, max_points=MAX_PTS, rgb_hw=IMG_HW,
                                 device="cpu")
    video = VideoRecorder(str(tmp_path_factory.mktemp("v") / "ep.avi"))
    trec = evaluate.evaluate_episode(
        TCFG, _models(params), ReplayEnv(
            make_synthetic_episode(n_frames=n, n_lidar=MAX_PTS,
                                   img_hw=IMG_HW, seed=0,
                                   bev_hw=(TCFG.ny, TCFG.nx)),
            TCFG, max_points=MAX_PTS),
        step_t, init_t, TICKS, video=video)
    return jrec, trec, video


def _close(tag, got, want):
    if want is None:
        assert got is None, tag
    else:
        assert math.isclose(got, want, rel_tol=REL, abs_tol=REL), (
            tag, got, want)


def test_expert_future_plan_frame_matches_lav_tpu():
    kw = dict(n_frames=JCFG.num_plan + 6, seed=1)
    jep, tep = j_episode(**kw), make_synthetic_episode(**kw)
    for t in range(5):
        want = JV._expert_future_plan_frame(jep, t, JCFG.num_plan)
        got = evaluate._expert_future_plan_frame(tep, t, TCFG.num_plan)
        assert got.shape == (TCFG.num_plan, 2)
        np.testing.assert_array_equal(got, want)


def test_evaluate_episode_matches_lav_tpu(records):
    jrec, trec, video = records
    for k in ("ticks", "brakes", "collides", "nan_controls"):
        assert trec[k] == jrec[k], k
    assert trec["ticks"] == TICKS
    for k in ("expert_plan_l2", "brake_agreement", "steer_expert_corr",
              "steer_abs_sum", "throttle_sum"):
        _close(k, trec[k], jrec[k])
    assert set(trec["latency"]) == set(jrec["latency"]) == {
        "mean_s", "p50_s", "p90_s", "steps_per_sec"}
    assert len(video) == TICKS
    assert avi_frames(video.close()) == TICKS


def test_results_json_matches_lav_tpu(records):
    jrec, trec, _ = records
    recs = [dict(jrec, collides=2), dict(jrec, nan_controls=1)]
    assert evaluate.make_results_json(recs) == JV.make_results_json(recs)
    out = evaluate.make_results_json([trec])
    assert set(out) == {"_checkpoint", "values", "labels"}
    r = out["_checkpoint"]["records"][0]
    assert r["status"] == "Completed"
    assert r["scores"]["score_composite"] == pytest.approx(
        r["scores"]["score_route"] * r["scores"]["score_penalty"], rel=1e-2)
    json.dumps(out)


@pytest.mark.parametrize("ticks", (4, 500))
def test_evaluate_batched_matches_lav_tpu(ticks):
    """500 ticks outruns the episodes: the loop stops, the stats so far
    are kept (`latency`, `ego_steps_per_sec`)."""
    ep_ticks, n = 6, 2
    kw = [dict(n_frames=ep_ticks + JCFG.num_plan + 1, n_lidar=MAX_PTS,
               img_hw=IMG_HW, bev_hw=(JCFG.ny, JCFG.nx), seed=10 + s)
          for s in range(n)]
    params = j_build_params(JCFG)
    init_j, step_j = j_build_agent(JCFG, max_points=MAX_PTS, rgb_hw=IMG_HW)
    want = JV.evaluate_batched(
        JCFG, params, [JReplayEnv(j_episode(**k), JCFG, max_points=MAX_PTS)
                       for k in kw], step_j, init_j, ticks)
    init_t, step_t = build_agent(TCFG, num_ego=n, max_points=MAX_PTS,
                                 rgb_hw=IMG_HW, device="cpu")
    got = evaluate.evaluate_batched(
        TCFG, _models(params),
        [ReplayEnv(make_synthetic_episode(**k), TCFG, max_points=MAX_PTS)
         for k in kw], step_t, init_t, ticks)
    for k in ("ticks", "nan_controls", "brakes"):
        assert got[k] == want[k], k
    assert set(got) == set(want)
    assert set(got["latency"]) == set(want["latency"])
    with pytest.raises(ValueError, match="built for"):
        evaluate.evaluate_batched(TCFG, _models(params), [None], step_t,
                                  init_t, 1)


def test_eval_priors_match_lav_tpu():
    """apply_eval_priors on lav_tpu's plain weights equals lav_tpu's
    build_params(eval_priors=True), leaf for leaf."""
    cfg_kw = dict(num_frame_stack=2)
    jcfg, tcfg = j_tiny_config(**cfg_kw), tiny_config(**cfg_kw)
    got = demo.apply_eval_priors(_models(j_build_params(jcfg, seed=4),
                                         tcfg))
    want = _models(j_build_params(jcfg, seed=4, eval_priors=True), tcfg)
    sd = want.state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert (got.uniplanner.cast_mlps.b[:, 1] == -0.5).all()


def test_obs_to_tensors_gives_lav_tpus_dtypes():
    frames = [dict(a=np.zeros(2), b=np.int64(3), c=np.zeros(1, bool),
                   d=np.float32(1.0)) for _ in range(3)]
    out = obs_to_tensors(frames, "cpu")
    assert out["a"].dtype == torch.float32 and out["a"].shape == (3, 2)
    assert out["b"].dtype == torch.int32 and out["b"].shape == (3,)
    assert out["c"].dtype == torch.bool and out["d"].dtype == torch.float32


def test_main_runs_on_the_cpu(tmp_path, capsys):
    out, avi = tmp_path / "r.json", tmp_path / "v.avi"
    res = evaluate.main(["--tiny", "--device", "cpu", "--episodes", "2",
                         "--ticks", "3", "--max-points", "64", "--out",
                         str(out), "--video", str(avi)])
    assert json.loads(out.read_text()) == res
    assert len(res["_checkpoint"]["records"]) == 2
    for e in range(2):
        assert avi_frames(tmp_path / f"v_{e}.avi") == 3
    rec = evaluate.main(["--tiny", "--device", "cpu", "--num-ego", "3",
                         "--ticks", "3", "--max-points", "64", "--out",
                         str(out)])
    assert rec["ticks"] == 9 and rec["nan_controls"] == 0
    assert "ego_steps_per_sec" in rec
    viz = tmp_path / "viz"
    run = demo.main(["--tiny", "--device", "cpu", "--ticks", "3",
                     "--max-points", "64", "--viz", str(viz)])
    assert run["controls"].shape == (3, 3)
    assert len(list(viz.iterdir())) == 3


def test_step_timer_and_trace(tmp_path):
    """lav_tpu's statistics over the steps after `warmup`; `trace` writes
    a Chrome trace of the block."""
    timer = StepTimer(warmup=1)
    path = tmp_path / "trace.json"
    with trace(str(path)):
        for _ in range(4):
            timer.start()
            dt = timer.stop({"x": [torch.ones(3) * 2]})
            assert dt >= 0
    st = timer.stats()
    assert len(timer.samples) == 3
    assert set(st) == {"mean_s", "p50_s", "p90_s", "steps_per_sec"}
    assert st["p50_s"] == sorted(timer.samples)[1]
    assert math.isclose(st["steps_per_sec"], 3 / sum(timer.samples))
    assert "traceEvents" in json.loads(path.read_text())
    assert StepTimer().stats() == {}
