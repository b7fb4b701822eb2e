"""The agent's `skip` and `det_override` options and the ground-truth
heatmaps against lav_tpu's on the CPU, at tiny_config with a temporal
stack (ring buffer, age one-hots, the v2 brake net).

* every `skip` stage, 3 ticks against lav_tpu's agent with the same
  params and observations: controls, plan, EKF, brake probability, BEV,
  the collision flag and the detections (atol 1e-4 / rtol 1e-3, the agent
  tests' tolerance); a skipped stage launches none of its kernels.  The
  lidar dummy's heatmaps are flat (sigmoid(0) everywhere), so every pixel
  ties; torch.topk orders tied scores otherwise than JAX's top_k, so the
  detection slots are compared after sorting by pixel;
* `det_override` with the route replay's scripted-scene maps at three
  ticks of a crossing: controls, plan, every other vehicle's cast, its
  command probabilities, `other_valid` (at least two vehicles) and
  `collide`;
* `detections_to_heatmap` against lav_tpu's, 1e-6: overlapping classes
  (a pedestrian over a vehicle, so the shared size / orientation maps
  keep the pedestrian's), equal Gaussians, masked objects and objects off
  the grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lav_tpu.agent import agent as JA
from lav_tpu.agent.demo import build_params as j_build_params
from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu.core.heatmap import detections_to_heatmap as j_heatmap
from lav_tpu_torch.agent.agent import SKIP_STAGES, AgentModels, build_agent
from lav_tpu_torch.agent.evaluate import (
    SCENE_BBOX, SCENE_TYPS, scene_maps, scripted_scene,
)
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.core import warp
from lav_tpu_torch.core.heatmap import detections_to_heatmap
from lav_tpu_torch.ops import pillar
from lav_tpu_torch.utils.weights import load_jax_params
from tests.test_agent import IMG_HW, _obs
from tests.torch_parity import assert_close

KW = dict(num_frame_stack=2, max_lidar_points=768)
ATOL, RTOL = 1e-4, 1e-3
SCENE_TICKS = (0, 6, 12)   # the crossing car left, ahead, right of the ego


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = j_tiny_config(**KW), tiny_config(**KW)
    params = j_build_params(jcfg, seed=3, eval_priors=True)
    models = load_jax_params(AgentModels(tcfg, brake_version=2),
                             jax.tree.map(np.asarray, params)).eval()
    return jcfg, tcfg, params, models


def _j_scene_maps(jcfg, t):
    locs, oris, valid = scripted_scene(t)
    hm, size, ori = j_heatmap(
        jnp.asarray(locs), jnp.asarray(oris), jnp.asarray(SCENE_BBOX),
        jnp.asarray(SCENE_TYPS), jnp.asarray(valid), h=jcfg.ny, w=jcfg.nx,
        pixels_per_meter=jcfg.pixels_per_meter, min_x=jcfg.min_x,
        min_y=jcfg.min_y, max_y=jcfg.max_y)
    return dict(det_heatmaps=hm, det_sizemaps=size, det_orimaps=ori)


def _run(setup, ticks, skip=(), det_override=False):
    """lav_tpu's and the port's agent over the same observations;
    -> [(ctrl_j, state_j, aux_j, ctrl_t, state_t, aux_t)] a tick."""
    jcfg, tcfg, params, models = setup
    init_j, step_j = JA.build_agent(jcfg, rgb_hw=IMG_HW, skip=skip,
                                    det_override=det_override)
    init_t, step_t = build_agent(tcfg, rgb_hw=IMG_HW, skip=skip,
                                 det_override=det_override, device="cpu")
    sj, st = init_j(), init_t()
    jstep = jax.jit(step_j)
    rng = np.random.default_rng(11)
    out = []
    for i, t in enumerate(ticks):
        obs = _obs(rng, sj.prev_lidar.shape[0], i)
        tobs = {k: torch.from_numpy(np.array(v))[None] for k, v in obs.items()}
        if det_override:
            obs.update(_j_scene_maps(jcfg, t))
            tobs.update(scene_maps(tcfg, [scripted_scene(t)], "cpu"))
        cj, sj, aj = jstep(params, sj, obs)
        ct, st, at = step_t(models, st, tobs)
        out.append((cj, sj, aj, ct, st, at))
    return out


def _valid_slots(dets, W):
    """The valid slots sorted by pixel index: where scores tie (the flat
    dummy maps, the zeros around ground-truth peaks), top-k orders and
    picks the invalid slots in its own way."""
    idx = np.flatnonzero(dets["valid"])
    key = dets["y"][idx].astype(np.int64) * W + dets["x"][idx]
    return idx[np.argsort(key, kind="stable")]


def _compare(tag, W, cj, sj, aj, ct, st, at, planner=True):
    for f in ("steer", "throttle", "brake"):
        assert_close(f"{tag}.{f}", getattr(ct, f)[0],
                     np.asarray(getattr(cj, f)), atol=ATOL, rtol=RTOL)
    for name in ("plan_locs", "pred_bra", "bev", "nxp"):
        assert_close(f"{tag}.{name}", at[name][0], aj[name], atol=ATOL,
                     rtol=RTOL)
    assert_close(f"{tag}.ekf", st.ekf.x[0], sj.ekf.x, atol=ATOL, rtol=RTOL)
    assert bool(at["collide"][0]) == bool(aj["collide"]), tag
    dj = {k: np.asarray(v) for k, v in aj["dets"].items()}
    dt = {k: v[0].numpy() for k, v in at["dets"].items()}
    oj, ot = _valid_slots(dj, W), _valid_slots(dt, W)
    assert len(oj) == len(ot), tag
    for k in ("x", "y", "w", "h", "cos", "sin", "score"):
        assert_close(f"{tag}.dets_{k}", dt[k][ot], dj[k][oj], atol=ATOL,
                     rtol=RTOL)
    valid = np.asarray(aj["other_valid"])[oj]
    assert (at["other_valid"][0].numpy()[ot] == valid).all(), tag
    assert int(at["other_valid"][0].sum()) == int(valid.sum()), tag
    for name in ("other_cast_locs", "other_cast_cmds"):
        assert_close(f"{tag}.{name}", at[name][0].numpy()[ot][valid],
                     np.asarray(aj[name])[oj][valid], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("stage", SKIP_STAGES)
def test_skip_stage_matches_lav_tpu(setup, stage, monkeypatch):
    calls = {"crop_shared": 0, "scatter": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(warp, "crop_shared",
                        spy("crop_shared", warp.crop_shared))
    for fn in ("scatter_max", "scatter_add", "pillar_scatter_max"):
        monkeypatch.setattr(pillar, fn, spy("scatter", getattr(pillar, fn)))
    W = setup[0].nx
    for t, tick in enumerate(_run(setup, range(3), skip=(stage,))):
        _compare(f"skip_{stage}.t{t}", W, *tick)
    if stage == "lidar":
        assert calls["scatter"] == 0 and calls["crop_shared"] == 3
    elif stage == "planner":
        assert calls["crop_shared"] == 0 and calls["scatter"] >= 3
    else:
        assert calls["crop_shared"] == 3 and calls["scatter"] >= 3


def test_unknown_skip_stage_raises():
    with pytest.raises(ValueError, match="unknown stages"):
        build_agent(tiny_config(), skip=("lidr",), device="cpu")


def test_det_override_matches_lav_tpu(setup):
    W = setup[0].nx
    seen = []
    for t, tick in zip(SCENE_TICKS, _run(setup, SCENE_TICKS,
                                         det_override=True)):
        _compare(f"det_override.t{t}", W, *tick)
        seen.append(int(tick[5]["other_valid"][0].sum()))
    # the planner crops real vehicles: both parked cars and, at some
    # ticks, the crossing one
    assert min(seen) >= 2 and max(seen) >= 3, seen


def _heatmap_cases():
    rng = np.random.default_rng(5)
    N = 12
    locs = rng.uniform(-6, 6, (N, 2)).astype(np.float32)
    locs[0] = locs[1]              # a pedestrian (0) over a vehicle (1)
    locs[2] = locs[3]              # two vehicles with equal Gaussians
    locs[4] = [40.0, 3.0]          # off the grid
    locs[5] = [-2.0, -30.0]
    oris = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    bbox = rng.uniform(0.3, 2.5, (N, 2)).astype(np.float32)
    typs = np.array([0, 1, 1, 1] + list(rng.integers(0, 2, N - 4)), np.int32)
    valid = np.ones(N, bool)
    valid[6] = False               # a masked object
    yield "mixed", locs, oris, bbox, typs, valid
    yield "all masked", locs, oris, bbox, typs, np.zeros(N, bool)
    yield "off grid", locs[4:6], oris[4:6], bbox[4:6], typs[4:6], valid[4:6]


@pytest.mark.parametrize("radius", (1.0, 2.5))
def test_detections_to_heatmap_matches_lav_tpu(radius):
    cfg = tiny_config()
    kw = dict(h=cfg.ny, w=cfg.nx, pixels_per_meter=cfg.pixels_per_meter,
              min_x=cfg.min_x, min_y=cfg.min_y, max_y=cfg.max_y,
              radius=radius)
    for name, *args in _heatmap_cases():
        want = j_heatmap(*map(jnp.asarray, args), **kw)
        got = detections_to_heatmap(*map(torch.from_numpy, args), **kw)
        for tag, g, w in zip(("heatmap", "sizemap", "orimap"), got, want):
            assert_close(f"heatmap.{name}.{tag}", g, np.asarray(w),
                         atol=1e-6)
