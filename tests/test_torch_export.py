"""The exported agent tick (`lav_tpu_torch/agent/export.py`) on the CPU.

* `export_agent_step` / `load_agent_step` of the tiny agent in f32 and in
  lav_tpu's serving configuration (bf16, "mxu" int8 with dynamic scales):
  the loaded program's controls, state and aux equal the eager tick's
  exactly (NaN positions equal) over 3 ticks, and the program calls the
  kernels as `lav_tpu_torch` custom ops (the int8 conv too in the serving
  one), each as often as the eager tick calls its wrapper;
* the port's export against lav_tpu's `export_agent_step` from the same
  params: f32 at atol 1e-4 / rtol 1e-3 (the agent tests' tolerance for
  f32 ticks), the serving configuration at 3e-2, the int8 golden's;
* the tick's named tuples come back as themselves, and export leaves the
  caller's models unquantized.
"""

import io

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.agent import export as JX
from lav_tpu.agent.agent import build_agent as j_build_agent
from lav_tpu.config import tiny_config
from lav_tpu_torch.agent import export as TX
from lav_tpu_torch.agent.agent import AgentState, Control, build_agent
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.core import warp
from lav_tpu_torch.nn import quant as Q
from lav_tpu_torch.ops import pillar
from tests.test_agent import IMG_HW, _obs, _params
from tests.test_torch_agent import _models, _t_obs
from tests.torch_parity import assert_close

P = 128
CONFIGS = {"f32": dict(), "serving": dict(compute_dtype=torch.bfloat16,
                                          quant_int8=True)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def exported():
    """(params, models, {config: (the loaded step, the custom ops its
    program calls, kw)}) of the tiny agent from lav_tpu's params."""
    torch.set_num_threads(1)
    params = _params(tiny_config())
    models = _models(t_tiny_config(), params, 1)
    out = {}
    for name, kw in CONFIGS.items():
        blob = TX.export_agent_step(t_tiny_config(), models, max_points=P,
                                    rgb_hw=IMG_HW, tel_hw=IMG_HW,
                                    device="cpu", **kw)
        assert isinstance(blob, bytes)
        graph = torch.export.load(io.BytesIO(blob)).graph
        ops = {n.target.name() for n in graph.nodes if n.op ==
               "call_function" and "lav_tpu_torch" in str(n.target)}
        out[name] = (TX.load_agent_step(blob), ops, kw)
    assert not list(Q.int8_convs(models))   # the caller's models stay float
    return params, models, out


def _obs_ticks(n=3):
    return [_obs(np.random.default_rng(40 + t), P, t) for t in range(n)]


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and (
        torch.equal(a, b) or torch.equal(torch.isnan(a), torch.isnan(b))
        and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)]))


class _Count:
    """Counts the calls of the kernels' plain versions, which the CPU
    tensors of both the eager tick and the custom ops' implementations
    take."""

    NAMES = ((pillar, "scatter_add_plain"), (pillar, "scatter_max_plain"),
             (pillar, "pillar_scatter_max_plain"),
             (warp, "grid_sample_shared"), (warp, "grid_sample_shared_q8"),
             (Q, "conv2d_int8_plain"))

    def __init__(self, monkeypatch):
        self.n = {name: 0 for _, name in self.NAMES}
        for mod, name in self.NAMES:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **k):
                self.n[_name] += 1
                return _real(*a, **k)
            monkeypatch.setattr(mod, name, spy)

    def take(self):
        n, self.n = self.n, dict.fromkeys(self.n, 0)
        return n


@pytest.mark.parametrize("config", list(CONFIGS))
def test_loaded_tick_equals_eager_tick(exported, config, monkeypatch):
    _, models, programs = exported
    step, ops, kw = programs[config]
    # uncalibrated int8 takes float crops (crop_shared_q8 needs a static
    # scale); the float transposed convs are an op too (their scoped
    # cuDNN flag, ROADMAP C10)
    want = {"lav_tpu_torch::scatter_add", "lav_tpu_torch::scatter_max",
            "lav_tpu_torch::crop_shared",
            "lav_tpu_torch::conv_transpose2d_deterministic"}
    assert ops == (want | {"lav_tpu_torch::conv2d_int8"} if kw else want)
    eager_models = TX.copy.deepcopy(models)
    if kw:
        Q.quantize_tree(eager_models.lidar_model)
        Q.quantize_tree(eager_models.uniplanner)
    init, eager = build_agent(t_tiny_config(), max_points=P, rgb_hw=IMG_HW,
                              compute_dtype=kw.get("compute_dtype"),
                              device="cpu")
    count = _Count(monkeypatch)
    s_l = s_e = init()
    for obs in _obs_ticks():
        o = _t_obs([obs])
        c_l, s_l, a_l = step(s_l, o)
        n_l = count.take()
        c_e, s_e, a_e = eager(eager_models, s_e, o)
        assert count.take() == n_l and n_l["scatter_add_plain"] == 1
        assert type(c_l) is Control and type(s_l) is AgentState
        for a, b in zip(jax.tree.leaves((tuple(c_l), tuple(s_l), a_l)),
                        jax.tree.leaves((tuple(c_e), tuple(s_e), a_e))):
            assert _same(a, b)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_export_matches_lav_tpu(exported, config):
    params, _, programs = exported
    t_step, _, kw = programs[config]
    jblob = JX.export_agent_step(
        tiny_config(), params, max_points=P, rgb_hw=IMG_HW, tel_hw=IMG_HW,
        compute_dtype=jnp.bfloat16 if kw else None,
        quant_int8=bool(kw))
    j_step = JX.load_agent_step(jblob)
    sj = j_build_agent(tiny_config(), max_points=P, rgb_hw=IMG_HW)[0]()
    st = build_agent(t_tiny_config(), max_points=P, rgb_hw=IMG_HW,
                     device="cpu")[0]()
    tol = dict(atol=3e-2, rtol=3e-2) if kw else dict(atol=1e-4, rtol=1e-3)
    for t, obs in enumerate(_obs_ticks()):
        cj, sj, aj = j_step(sj, obs)
        ct, st, at = t_step(st, _t_obs([obs]))
        for f in ("steer", "throttle", "brake"):
            assert_close(f"export.{config}.{f}", getattr(ct, f)[0],
                         np.asarray(getattr(cj, f)), **tol)
        assert_close(f"export.{config}.plan", at["plan_locs"][0],
                     aj["plan_locs"], **tol)
        assert_close(f"export.{config}.ekf", st.ekf.x[0], sj.ekf.x, **tol)


def test_loaded_step_drives_the_route_replay(exported, tmp_path):
    """evaluate_routes with a caller's step (lav_tpu's contract): the loaded
    program, called as step(state, obs), on the network's own detections
    (gt_perception=False), gives the eager agent's records."""
    from lav_tpu_torch.agent import evaluate, routes
    from tests.test_torch_routes import write_routes

    _, models, programs = exported
    step, _, _ = programs["f32"]
    init, _ = build_agent(t_tiny_config(), max_points=P, rgb_hw=IMG_HW,
                          device="cpu")
    rs = routes.parse_routes(write_routes(tmp_path / "r.xml"))[:1]
    kw = dict(max_ticks=12, speed=25.0, max_points=P, rgb_hw=IMG_HW,
              tel_hw=IMG_HW, gt_perception=False)
    got = evaluate.evaluate_routes(t_tiny_config(), None, rs, step, init,
                                   device="cpu", **kw)
    want = evaluate.evaluate_routes(t_tiny_config(), models, rs, **kw)
    for rec in got + want:
        rec.pop("latency")
    assert got == want and got[0]["ticks"] >= 10
