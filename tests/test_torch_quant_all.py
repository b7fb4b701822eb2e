"""The all-stacks int8 scope (lav_tpu's `quantize_tree(params)` over the
whole agent, `__graft_entry__.py:64-77`) in the port, on the CPU.

* `quantize_tree(AgentModels)` quantizes exactly the convs lav_tpu's
  whole-tree `quantize_tree` does (the camera ERFNet with its decoder's
  transposed convs, the brake net's ResNet and seg head conv, the lidar
  model, the planner; the 3-channel stems, `up*`, `upconv*`,
  `output_conv` and `conv1_0` stay float), with the same int8 weights and
  scales, exactly;
* every such conv of the full-width v2 agent fits kernel `conv2d_int8`'s
  tables (at most 16 phases and 16 taps a phase and axis; ROADMAP C4):
  the camera nets' 3x1 / 1x3 convs with dilation up to 16;
* the tiny agent quantized by lav_tpu's whole-tree scope and calibrated
  by the port, 3 ticks in bf16 against lav_tpu's at atol/rtol 3e-2, the
  int8 golden's tolerance;
* lav_tpu's 100-tick policy envelope (tests/test_quant.py:89) for the
  port: f32 against the whole-tree int8 agent and the "mxu" one with
  dynamic activation scales on a replayed synthetic episode, steer and
  throttle within 0.05, the brake flipping on at most 10% of ticks;
* `v2_agent_setup` takes quant="all" and refuses an unknown scope.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.nn import quant as JQ
from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.agent.setup import v2_agent_setup
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.config import v2_config as t_v2_config
from lav_tpu_torch.nn import quant as Q
from lav_tpu_torch.nn.layers import ConvTranspose2d
from tests.test_agent import IMG_HW, _obs, _params
from tests.test_torch_agent import (
    _compare_prod, _models, _run_both, _t_obs,
)
from tests.test_torch_quant import _jax_int8, _np


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_quantize_tree_whole_agent_matches_lav_tpu():
    cfg = tiny_config()
    params = _params(cfg)
    ref = {p: d for p, d in _jax_int8(_np(JQ.quantize_tree(params))).items()
           if not p.startswith("/uniplanner/bev_planner")}  # not in the port
    models = _models(t_tiny_config(), params, 1)
    got = dict(Q.int8_convs(Q.quantize_tree(models)))
    assert set(got) == set(ref)
    for stack in ("/seg_model/", "/bra_model/", "/lidar_model/",
                  "/uniplanner/"):
        assert any(p.startswith(stack) for p in got), stack
    # the ERFNet decoder's upsamplers are walked (keys dec_i/conv), its
    # output_conv and the brake seg head's up1-3 are not
    assert "/seg_model/erfnet/dec_0/conv" in got
    assert isinstance(models.seg_model.erfnet.dec_0.conv, ConvTranspose2d)
    for float_conv in ("/seg_model/erfnet/output_conv",
                       "/seg_model/erfnet/initial/conv",
                       "/bra_model/seg_head/up1",
                       "/bra_model/conv_backbone/conv1",
                       "/lidar_model/backbone/conv1_0/conv"):
        assert float_conv not in got, float_conv
    for path, conv in got.items():
        w = np.asarray(ref[path]["w_int8"])
        if isinstance(conv, ConvTranspose2d):
            w = np.flip(w, (0, 1))
        np.testing.assert_array_equal(conv.w_int8.numpy(),
                                      w.transpose(3, 0, 1, 2), err_msg=path)
        np.testing.assert_array_equal(conv.w_scale.numpy(),
                                      np.asarray(ref[path]["w_scale"]),
                                      err_msg=path)


def test_every_whole_tree_conv_fits_the_kernel_tables():
    """The full-width v2 agent's int8 convs under quant="all", each planned
    at the input it meets at 16 egos (`_plan_ints` raises past the
    tables); the camera convs' dilations reach 16."""
    models = Q.quantize_tree(AgentModels(t_v2_config(), brake_version=2,
                                         gen=torch.Generator().manual_seed(0)))
    convs = dict(Q.int8_convs(models))
    cam = {p: c for p, c in convs.items() if p.startswith("/seg_model/")}
    assert max(c.dilation[0] * c.dilation[1] for c in cam.values()
               if not isinstance(c, ConvTranspose2d)) == 16
    for path, c in convs.items():
        kh, kw = c.ksize
        if isinstance(c, ConvTranspose2d):
            pads = tuple((k - 1 - p, k - 1 - p + op) for k, p, op in zip(
                c.ksize, c.padding, c.output_padding))
            args = ((1, 1), pads, (1, 1), tuple(c.stride))
        else:
            args = (tuple(c.stride), Q._pads(c.padding), tuple(c.dilation),
                    (1, 1))
        OH, OW, plan = Q._plan_ints(48, 36, 32, -(-c.cin // 16) * 16,
                                    c.cout, kh, kw, *args, 132)
        assert OH > 0 and OW > 0 and len(plan) == 591, path


def _calibrated_all(cfg, tcfg):
    """lav_tpu's whole-tree quantize; the port calibrates (two f32 observer
    ticks) and lav_tpu's params take its scales."""
    params = JQ.quantize_tree(_params(cfg))
    models = _models(tcfg, params, 1)
    init_t, step_t = build_agent(tcfg, rgb_hw=IMG_HW, device="cpu")

    def calib():
        state = init_t()
        for t in range(2):
            P = state.prev_lidar.shape[1]
            obs = _t_obs([_obs(np.random.default_rng(90 + t), P, t)])
            _, state, _ = step_t(models, state, obs)

    Q.calibrate(calib)
    for path, conv in Q.int8_convs(models):
        if conv.x_scale is None:   # not on the tick: the brake seg head
            assert path == "/bra_model/seg_head/out", path
            continue
        node = params
        for key in path.strip("/").split("/"):
            node = node[key]
        node["x_scale"] = jnp.float32(float(conv.x_scale))
    return params


def test_tiny_agent_all_stacks_int8_matches_jax():
    cfg, tcfg = tiny_config(), t_tiny_config()
    params = _calibrated_all(cfg, tcfg)
    ticks = _run_both(cfg, tcfg, params, 1, 3,
                      lambda t, P: _obs(np.random.default_rng(t), P, t),
                      dtype=torch.bfloat16)
    _compare_prod("tiny_int8_all", ticks)


def test_policy_envelope_over_100_ticks():
    from lav_tpu_torch.agent.demo import build_params
    from lav_tpu_torch.agent.env import ReplayEnv, obs_to_tensors
    from lav_tpu_torch.data.store import make_synthetic_episode

    tcfg = t_tiny_config()
    img_hw, P, n_ticks = (32, 32), 128, 100
    init_state, step = build_agent(tcfg, max_points=P, rgb_hw=img_hw,
                                   device="cpu")
    full = build_params(tcfg, device="cpu")
    whole = Q.quantize_tree(build_params(tcfg, device="cpu"))
    mxu = build_params(tcfg, device="cpu")
    Q.quantize_tree(mxu.lidar_model)
    Q.quantize_tree(mxu.uniplanner)
    env = ReplayEnv(make_synthetic_episode(
        n_frames=n_ticks + tcfg.num_plan + 1, n_lidar=P, img_hw=img_hw,
        bev_hw=(tcfg.ny, tcfg.nx), seed=5), tcfg, max_points=P)
    frames = [f for _, f in zip(range(n_ticks), env.frames())]
    traces = {}
    with torch.no_grad():
        for name, models in (("f32", full), ("all", whole), ("mxu", mxu)):
            state, out = init_state(), []
            for f in frames:
                ctrl, state, _ = step(models, state,
                                      obs_to_tensors([f], "cpu"))
                out.append([float(c[0]) for c in ctrl])
            traces[name] = np.asarray(out)
    for q in ("all", "mxu"):
        d = np.abs(traces["f32"] - traces[q])
        assert d[:, 0].max() < 0.05, f"{q} steer {d[:, 0].max()}"
        assert d[:, 1].max() < 0.05, f"{q} throttle {d[:, 1].max()}"
        assert (traces["f32"][:, 2] != traces[q][:, 2]).mean() <= 0.10


def test_setup_scopes():
    with pytest.raises(ValueError, match="'all'"):
        v2_agent_setup(device="cpu", quant="some")
    with pytest.raises(ValueError, match="int8_upconv"):
        v2_agent_setup(device="cpu", int8_upconv=True)
