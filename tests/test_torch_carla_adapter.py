"""The port's CARLA adapter (lav_tpu_torch.agent.carla_adapter) through
stub carla / leaderboard modules, and its core against lav_tpu's.

The simulator is not installed; the stubs carry the leaderboard protocol
(get_entry_point, sensors(), setup(), run_step(input_data, ts) ->
VehicleControl, destroy()) as `tests/test_carla_adapter.py` builds them.
`setup` reads a YAML whose `*_dir` entries point at checkpoints saved by
`train/checkpoints.py` (a training snapshot and bare state_dicts), and the
agent must hold exactly those weights.  `LAVAgentCore` runs 3 ticks
against lav_tpu's on the same weights and sensors (sweeps longer than
`max_points`, which both cut) at the agent's atol 1e-4 / rtol 1e-3.
"""

import functools
import importlib
import sys
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from lav_tpu.agent import carla_adapter as JCA
from lav_tpu.agent.demo import build_params as j_build_params
from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu_torch.agent.agent import AgentModels
from lav_tpu_torch.agent.carla_adapter import LAVAgentCore
from lav_tpu_torch.agent.demo import build_params
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.train.checkpoints import save_checkpoint
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close

MAX_PTS, RGB_HW = 128, (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class _FakeVehicleControl:
    def __init__(self, steer=0.0, throttle=0.0, brake=0.0):
        self.steer = steer
        self.throttle = throttle
        self.brake = brake


class _FakeAutonomousAgent:
    """The leaderboard's AutonomousAgent protocol, minimal."""

    def __init__(self, path_to_conf_file=None):
        self._global_plan = None
        self.setup(path_to_conf_file)

    def set_global_plan(self, global_plan_gps, global_plan_world=None):
        self._global_plan = global_plan_gps


@pytest.fixture()
def adapter(monkeypatch):
    carla_stub = types.ModuleType("carla")
    carla_stub.VehicleControl = _FakeVehicleControl
    lb_auto = types.ModuleType("leaderboard.autoagents.autonomous_agent")
    lb_auto.AutonomousAgent = _FakeAutonomousAgent
    lb_auto.Track = types.SimpleNamespace(SENSORS="SENSORS")
    monkeypatch.setitem(sys.modules, "carla", carla_stub)
    monkeypatch.setitem(sys.modules, "leaderboard",
                        types.ModuleType("leaderboard"))
    monkeypatch.setitem(sys.modules, "leaderboard.autoagents",
                        types.ModuleType("leaderboard.autoagents"))
    monkeypatch.setitem(sys.modules,
                        "leaderboard.autoagents.autonomous_agent", lb_auto)

    import lav_tpu_torch.agent.carla_adapter as ca

    ca = importlib.reload(ca)
    assert ca.LAVAgent is not None, "adapter did not bind with carla present"
    monkeypatch.setattr(ca, "LAVAgentCore", functools.partial(
        ca.LAVAgentCore, max_points=MAX_PTS, rgb_hw=RGB_HW, device="cpu"))
    yield ca
    importlib.reload(ca)  # the carla-less binding for other tests


def _sensors(rng, t, cfg, n_points):
    data = {
        "LIDAR": (t, rng.uniform(-4, 10, (n_points, 4)).astype(np.float32)),
        "GPS": (t, np.array([1e-5 * t, 2e-5 * t, 0.0])),
        "IMU": (t, np.array([0, 0, 0, 0, 0, 0, 0.1 * t])),
        "EGO": (t, {"speed": 3.0}),
        "TEL_RGB": (t, rng.integers(0, 255, (cfg.crop_tel_bottom + 24, 48, 4),
                                    dtype=np.uint8)),
    }
    for i in range(3):
        data[f"RGB_{i}"] = (t, rng.integers(0, 255, (*RGB_HW, 4),
                                            dtype=np.uint8))
    return data


PLAN = [({"lat": 1e-5 * i, "lon": 2e-5 * i}, 4 if i % 3 else 1)
        for i in range(8)]


def test_carla_adapter_full_protocol(adapter, tmp_path):
    ca = adapter
    assert ca.get_entry_point() == "LAVAgent"
    cfg = tiny_config(num_frame_stack=2, max_lidar_points=768)
    keys = ("num_plan num_plan_iter min_x max_x min_y max_y "
            "pixels_per_meter crop_size max_lidar_points max_objs "
            "max_num_cars max_num_cars_student max_det turn_n speed_n "
            "num_frame_stack").split()
    # checkpoints as the training CLI leaves them: a snapshot for the
    # lidar model, bare state_dicts for the rest
    trained = AgentModels(cfg, brake_version=2,
                          gen=torch.Generator().manual_seed(9))
    dirs = {}
    for name in ("lidar_model", "uniplanner", "seg_model", "bra_model"):
        sd = getattr(trained, name).state_dict()
        tree = (dict(params=sd, opt_state={}, epoch=1, it=2)
                if name == "lidar_model" else sd)
        dirs[f"{name}_dir"] = save_checkpoint(str(tmp_path / name / "ck.th"),
                                              tree)
    conf = tmp_path / "conf.yaml"
    conf.write_text(yaml.dump(
        {k: getattr(cfg, k) for k in keys}
        | {"num_features": list(cfg.num_features)} | dirs))

    agent = ca.LAVAgent(str(conf))
    held = agent.core.models.state_dict()
    for k, v in trained.state_dict().items():
        assert torch.equal(held[k], v), k
    ids = {s["id"] for s in agent.sensors()}
    assert {"EGO", "GPS", "IMU", "LIDAR", "RGB_0", "RGB_1", "RGB_2",
            "TEL_RGB"} <= ids
    agent.set_global_plan(PLAN)
    rng = np.random.default_rng(0)
    controls = []
    for t in range(3):
        ctrl = agent.run_step(_sensors(rng, t, cfg, 100), t)
        assert isinstance(ctrl, _FakeVehicleControl)
        assert -1 <= ctrl.steer <= 1
        assert 0 <= ctrl.throttle <= 1 and 0 <= ctrl.brake <= 1
        controls.append((ctrl.steer, ctrl.throttle, ctrl.brake))
    assert np.isfinite(np.asarray(controls)).all()
    assert int(agent.core.state.num_frames[0]) == 3
    agent.destroy()
    assert agent.core is None


@pytest.mark.parametrize("stack", (0, 2))
def test_agent_core_matches_lav_tpu(stack):
    kw = dict(num_frame_stack=stack, max_lidar_points=768)
    jcfg, tcfg = j_tiny_config(**kw), tiny_config(**kw)
    params = j_build_params(jcfg, seed=5, eval_priors=True)
    jcore = JCA.LAVAgentCore(jcfg, params, max_points=MAX_PTS, rgb_hw=RGB_HW)
    models = load_jax_params(
        AgentModels(tcfg, brake_version=2 if stack else 1),
        jax.tree.map(np.asarray, params))
    tcore = LAVAgentCore(tcfg, models, max_points=MAX_PTS, rgb_hw=RGB_HW,
                         device="cpu")
    for core in (jcore, tcore):
        core.set_global_plan(PLAN)
    rng = np.random.default_rng(3)
    for t in range(3):
        d = _sensors(rng, t, jcfg, MAX_PTS + 40)   # cut to MAX_PTS
        rgbs = np.stack([d[f"RGB_{i}"][1][..., :3] for i in range(3)])
        tel = d["TEL_RGB"][1][..., :3][:-jcfg.crop_tel_bottom]
        args = (d["LIDAR"][1], rgbs, tel, d["GPS"][1], d["IMU"][1][-1], 3.0)
        *jc, ja = jcore.run_step(*args)
        *tc, ta = tcore.run_step(*args)
        assert_close(f"carla_core.t{t}.controls", np.asarray(tc),
                     np.asarray(jc), atol=1e-4, rtol=1e-3)
        for name in ("plan_locs", "nxp", "pred_bra"):
            assert_close(f"carla_core.t{t}.{name}", ta[name][0], ja[name],
                         atol=1e-4, rtol=1e-3)
    assert jcore.waypointer.current_idx == tcore.waypointer.current_idx


def test_build_params_is_seeded():
    a = build_params(tiny_config(), seed=1, device="cpu").state_dict()
    b = build_params(tiny_config(), seed=1, device="cpu").state_dict()
    c = build_params(tiny_config(), seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
