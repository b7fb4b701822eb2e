"""The port's agent tick against lav_tpu's on the CPU, and the port's rules.

* the tiny agent, 3 ticks, against lav_tpu live and against
  tests/golden/agent_controls.npz (atol 1e-4 / rtol 1e-3, the golden's own);
* the tiny temporal-stack agent (ring buffer, age one-hots, v2 brake net),
  7 ticks, against lav_tpu;
* egos batched with different histories (different ring-buffer slots)
  against the same egos run one at a time;
* the full-width v2 agent, 2 ticks, with params and observations from
  `__graft_entry__._v2_agent_setup(max_points=2048)` converted by the
  port's loader, against tests/golden/v2_agent_production_f32.npz at the
  golden's atol 1e-4 / rtol 1e-3;
* EKF, PID and the control overrides against lav_tpu;
* no file of lav_tpu_torch imports jax or lav_tpu, and the entry points
  raise when `cuda` is asked for on a machine without a card.
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.agent import agent as JA
from lav_tpu.agent import control as JC
from lav_tpu.agent import ekf as JE
from lav_tpu.config import tiny_config
from lav_tpu.models.lidar import lidar_model_init
from lav_tpu.models.planner import uniplanner_init
from lav_tpu.models.rgb import brake_model_init, seg_model_init
from lav_tpu_torch.agent import control as TC
from lav_tpu_torch.agent import ekf as TE
from lav_tpu_torch.agent.agent import AgentModels, AgentState, build_agent
from lav_tpu_torch.agent.pid import pid_make
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.config import v2_config as t_v2_config
from lav_tpu_torch.utils.weights import load_jax_params
from tests.test_agent import IMG_HW, _obs, _params
from tests.torch_parity import assert_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(cfg, params, version):
    models = AgentModels(cfg, brake_version=version)
    return load_jax_params(models, jax.tree.map(np.asarray, params)).eval()


def _t_obs(obs_list):
    """Stack per-ego JAX/numpy observations into the port's (E, ...) form."""
    return {k: torch.from_numpy(np.stack([np.array(o[k]) for o in obs_list]))
            for k in obs_list[0]}


def _run_both(jcfg, tcfg, params, version, n_ticks, obs_fn):
    init_j, step_j = JA.build_agent(jcfg, rgb_hw=IMG_HW)
    init_t, step_t = build_agent(tcfg, rgb_hw=IMG_HW, device="cpu")
    models = _models(tcfg, params, version)
    sj, st = init_j(), init_t()
    jstep = jax.jit(step_j)
    out = []
    for t in range(n_ticks):
        obs = obs_fn(t, sj.prev_lidar.shape[0])
        cj, sj, aj = jstep(params, sj, obs)
        ct, st, at = step_t(models, st, _t_obs([obs]))
        out.append((cj, sj, aj, ct, st, at))
    return out


def _compare_tick(tag, cj, sj, aj, ct, st, at):
    for f in ("steer", "throttle", "brake"):
        assert_close(f"agent.{tag}.{f}", getattr(ct, f)[0],
                     np.asarray(getattr(cj, f)), atol=1e-4, rtol=1e-3)
    assert_close(f"agent.{tag}.plan", at["plan_locs"][0], aj["plan_locs"],
                 atol=1e-4, rtol=1e-3)
    assert_close(f"agent.{tag}.ekf", st.ekf.x[0], sj.ekf.x, atol=1e-4,
                 rtol=1e-3)
    assert_close(f"agent.{tag}.pred_bra", at["pred_bra"][0], aj["pred_bra"],
                 atol=1e-5)
    assert_close(f"agent.{tag}.bev", at["bev"][0], aj["bev"], atol=1e-4,
                 rtol=1e-3)
    valid = np.asarray(aj["dets"]["valid"])
    assert_close(f"agent.{tag}.dets_valid", at["dets"]["valid"][0].int(),
                 valid.astype(np.int32), atol=0.0)
    for f in ("x", "y"):
        assert_close(f"agent.{tag}.dets_{f}", at["dets"][f][0].numpy()[valid],
                     np.asarray(aj["dets"][f])[valid], atol=0.0)
    for name in ("buf_ptr", "buf_count", "num_frames"):
        assert int(getattr(st, name)[0]) == int(getattr(sj, name))


def test_tiny_agent_matches_jax_and_golden():
    cfg = tiny_config()
    params = _params(cfg)
    ticks = _run_both(cfg, t_tiny_config(), params, 1, 3,
                      lambda t, P: _obs(np.random.default_rng(t), P, t))
    for t, tick in enumerate(ticks):
        _compare_tick("tiny", *tick)
    golden = np.load(os.path.join(GOLDEN, "agent_controls.npz"))
    controls = np.asarray([[float(c[0]) for c in tick[3]] for tick in ticks],
                          np.float32)
    assert_close("agent.tiny.golden_controls", controls, golden["controls"],
                 atol=1e-4, rtol=1e-3)
    assert_close("agent.tiny.golden_plan", ticks[-1][5]["plan_locs"][0],
                 golden["plan"], atol=1e-4, rtol=1e-3)
    assert_close("agent.tiny.golden_ekf", ticks[-1][4].ekf.x[0],
                 golden["ekf"], atol=1e-4, rtol=1e-3)


def test_temporal_stack_agent_matches_jax():
    """num_frame_stack=2: the ring buffer, re-registration of past sweeps,
    age one-hot channels and the v2 brake net over 7 ticks."""
    kw = dict(num_frame_stack=2, max_lidar_points=768)
    cfg, tcfg = tiny_config(**kw), t_tiny_config(**kw)
    ks = jax.random.split(jax.random.key(9), 4)
    params = {
        "lidar_model": lidar_model_init(ks[0], cfg.num_input,
                                        cfg.num_features),
        "uniplanner": uniplanner_init(ks[1], cfg),
        "seg_model": seg_model_init(ks[2], len(cfg.seg_channels)),
        "bra_model": brake_model_init(ks[3], 3, version=2),
    }
    rng = np.random.default_rng(21)

    def obs_fn(t, P):
        o = _obs(rng, P, t)
        o["speed"] = jnp.asarray(2.0 + t, jnp.float32)
        o["cmd"] = jnp.asarray(t % 6, jnp.int32)
        return o

    ticks = _run_both(cfg, tcfg, params, 2, 7, obs_fn)
    for tick in ticks:
        _compare_tick("stack", *tick)
    st = ticks[-1][4]
    assert int(st.buf_count[0]) == 6 and int(st.buf_ptr[0]) == 6


def _stack_states(states):
    def cat(xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*[cat(list(f)) for f in zip(*xs)])
        return torch.cat(xs, dim=0)
    return AgentState(*[cat(list(f)) for f in zip(*states)])


def test_batched_egos_match_single_egos():
    """Two egos at different ring-buffer slots in one batch give what each
    gives alone."""
    kw = dict(num_frame_stack=2, max_lidar_points=512)
    tcfg = t_tiny_config(**kw)
    gen = torch.Generator().manual_seed(3)
    models = AgentModels(tcfg, brake_version=2, gen=gen).eval()
    init1, step1 = build_agent(tcfg, rgb_hw=IMG_HW, device="cpu")
    init2, step2 = build_agent(tcfg, num_ego=2, rgb_hw=IMG_HW, device="cpu")
    P = init1().prev_lidar.shape[1]

    def obs(seed, t):
        return _t_obs([_obs(np.random.default_rng(seed), P, t)])

    a, b = init1(), init1()
    for t in range(4):          # ego a runs ahead by 3 ticks
        _, a, _ = step1(models, a, obs(100 + t, t))
    assert int(a.buf_ptr[0]) != int(b.buf_ptr[0])
    both = _stack_states([a, b])
    for t in range(3):
        oa, ob = obs(200 + t, 4 + t), obs(300 + t, t)
        ca, a, aa = step1(models, a, oa)
        cb, b, ab = step1(models, b, ob)
        cab, both, aab = step2(models, both, {k: torch.cat([oa[k], ob[k]])
                                              for k in oa})
        for e, (c1, a1) in enumerate(((ca, aa), (cb, ab))):
            for f in ("steer", "throttle", "brake"):
                assert_close("agent.batched", getattr(cab, f)[e],
                             getattr(c1, f)[0], atol=1e-5)
            assert_close("agent.batched", aab["plan_locs"][e],
                         a1["plan_locs"][0], atol=1e-5)
        assert_close("agent.batched", both.lidar_buf[0], a.lidar_buf[0],
                     atol=0.0)
        assert_close("agent.batched", both.lidar_buf[1], b.lidar_buf[0],
                     atol=0.0)


def test_v2_agent_full_width_matches_production_golden():
    import __graft_entry__ as g

    _, params, _, jobs, _ = g._v2_agent_setup(max_points=2048)
    cfg = t_v2_config()
    models = _models(cfg, params, 2)
    init_state, step = build_agent(cfg, max_points=2048, device="cpu")
    state = init_state()
    obs = _t_obs([jobs])
    controls = []
    for _ in range(2):
        ctrl, state, aux = step(models, state, obs)
        controls.append([float(c[0]) for c in ctrl])
    golden = np.load(os.path.join(GOLDEN, "v2_agent_production_f32.npz"))
    assert_close("agent.v2_full_width.controls",
                 np.asarray(controls, np.float32), golden["controls"],
                 atol=1e-4, rtol=1e-3)
    assert_close("agent.v2_full_width.plan", aux["plan_locs"][0],
                 golden["plan"], atol=1e-4, rtol=1e-3)
    assert_close("agent.v2_full_width.ekf", state.ekf.x[0], golden["ekf"],
                 atol=1e-4, rtol=1e-3)


def test_ekf_matches_jax(rng):
    jc, tc = JE.ekf_make(), TE.ekf_make()
    js, ts = JE.ekf_init_state(), TE.ekf_init_state(1)
    for t in range(6):
        spd, steer = rng.uniform(0, 8), rng.uniform(-1, 1)
        lat, lon, comp = 1e-4 * (1 + t), 2e-4, rng.uniform(-3, 3)
        js = JE.ekf_predict_update(jc, js, spd, steer, lat, lon, comp)
        f = lambda v: torch.tensor([v], dtype=torch.float32)
        ts = TE.ekf_predict_update(tc, ts, f(spd), f(steer), f(lat), f(lon),
                                   f(comp))
        assert_close("agent.ekf.x", ts.x[0], js.x, atol=1e-4, rtol=1e-5)
        assert_close("agent.ekf.P", ts.P[0], js.P, atol=1e-9, rtol=1e-4)


def test_pid_control_and_collide_match_jax(rng):
    cfg = tiny_config(num_plan=10)
    jctl = dict(
        turn_pid=JA.pid_make(1.0, 0.5, 0.2, 8),
        speed_pid=JA.pid_make(5.0, 0.5, 1.0, 8),
        aim_point=jnp.asarray([4, 4, 4, 3, 6, 6], jnp.int32),
        speed_ratio=jnp.asarray([0.8, 0.8, 0.8, 0.6, 0.8, 0.8]),
        pixels_per_meter=4.0, brake_speed=0.2, clip_delta=0.25,
        max_throttle=0.8)
    tctl = dict(jctl, turn_pid=pid_make(1.0, 0.5, 0.2, 8),
                speed_pid=pid_make(5.0, 0.5, 1.0, 8),
                aim_point=torch.tensor([4, 4, 4, 3, 6, 6]),
                speed_ratio=torch.tensor([0.8, 0.8, 0.8, 0.6, 0.8, 0.8]))
    jtw, jsw = jnp.zeros(8), jnp.zeros(8)
    ttw, tsw = torch.zeros(1, 8), torch.zeros(1, 8)
    for t in range(5):
        wps = np.cumsum(rng.normal(size=(cfg.num_plan, 2)), 0).astype(
            np.float32)
        spd, cmd = float(rng.uniform(0, 5)), int(t % 6)
        js, jt, jb, jtw, jsw = JC.pid_control(jctl, jtw, jsw,
                                              jnp.asarray(wps), spd, cmd)
        ts, tt, tb, ttw, tsw = TC.pid_control(
            tctl, ttw, tsw, torch.from_numpy(wps)[None],
            torch.tensor([spd]), torch.tensor([cmd]))
        for name, a, b in (("steer", ts, js), ("throttle", tt, jt),
                           ("brake", tb.int(), np.int32(jb))):
            assert_close(f"agent.pid_control.{name}", a[0], b, atol=1e-5)
    K, C, T = 4, 3, cfg.num_plan
    ego = np.cumsum(rng.normal(size=(T, 2)), 0).astype(np.float32)
    other = (ego[None, None] + rng.normal(scale=2.0, size=(K, C, T, 2))
             ).astype(np.float32)
    cmds = rng.uniform(size=(K, C)).astype(np.float32)
    for valid in ([True] * K, [False, True, False, True], [False] * K):
        kw = dict(pixels_per_meter=4.0, cmd_thresh=0.2, brake_speed=0.2)
        ref = JC.plan_collide(jnp.asarray(ego), jnp.asarray(other),
                              jnp.asarray(cmds), jnp.asarray(valid), **kw)
        out = TC.plan_collide(torch.from_numpy(ego)[None],
                              torch.from_numpy(other)[None],
                              torch.from_numpy(cmds)[None],
                              torch.tensor([valid]), **kw)
        assert bool(out[0]) == bool(ref)


def test_port_imports_neither_jax_nor_lav_tpu():
    offenders = []
    for path in sorted((REPO / "lav_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "lav_tpu", "flax", "optax"):
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert not offenders, offenders
    smoke = (REPO / "chip_smoke.py").read_text()
    for node in ast.walk(ast.parse(smoke)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "lav_tpu")
                           for n in names), names


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    from lav_tpu_torch.agent.setup import v2_agent_setup
    from lav_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_agent(t_tiny_config(), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        v2_agent_setup(max_points=64)
    assert resolve_device("cpu").type == "cpu"
