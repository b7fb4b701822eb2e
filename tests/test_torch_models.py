"""lav_tpu_torch models against lav_tpu models on the CPU, at tiny_config.

Params are initialised by lav_tpu and converted by the port's loader;
inputs are drawn with numpy from a seed.  f32, atol 1e-4 / rtol 1e-4 for
the deep nets (summation order through tens of layers), tighter for the
decode steps.  Detections are compared through their valid mask, since
tied scores may be ordered differently by the two top-k implementations.

The production configuration (bf16 compute, int8 "mxu" convs with static
scales from lav_tpu's calibration) is held to atol/rtol 3e-2, the int8
golden's tolerance (tests/test_golden_production.py): bf16 roundings in
another order move an activation by an ulp, and an int8 quantize may then
land one step apart.  The camera nets in bf16 take the same tolerance.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.models import lidar as JLid
from lav_tpu.models import planner as JPl
from lav_tpu.models import rgb as JRgb
from lav_tpu.nn import quant as JQ
from lav_tpu.ops import painting as JPaint
from lav_tpu.ops import peak as JPeak
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.models.lidar import LidarModel
from lav_tpu_torch.models.planner import UniPlanner, uniplanner_infer
from lav_tpu_torch.models.rgb import BrakeModel, SegModel
from lav_tpu_torch.core import warp as TWarp
from lav_tpu_torch.ops import painting as TPaint
from lav_tpu_torch.ops import peak as TPeak
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close

CFG = tiny_config()
TCFG = t_tiny_config()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _load(module, tree):
    return load_jax_params(module, jax.tree.map(np.asarray, tree)).eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _geo(cfg):
    return dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
                max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)


def _lidar_model(key):
    params = JLid.lidar_model_init(jax.random.key(key), CFG.num_input,
                                   CFG.num_features)
    model = _load(LidarModel(TCFG.num_input, TCFG.num_features,
                             **_geo(TCFG)), params)
    return params, model


def test_lidar_model_matches_jax_and_golden():
    params, model = _lidar_model(11)
    pts = np.random.default_rng(7).uniform(
        -5, 10, (1, 96, CFG.num_input - 5)).astype(np.float32)
    valid = np.ones((1, 96), bool)
    ref = JLid.lidar_model_apply(
        params, jnp.asarray(pts), jnp.asarray(valid), train=False,
        num_features=CFG.num_features, **_geo(CFG))
    with torch.no_grad():
        out = model(_t(pts), _t(valid))
    names = ("features", "heatmap", "sizemap", "orimap", "bev_seg")
    for name, o, r in zip(names, out, ref[:5]):
        assert_close(f"models.lidar.{name}", o, r, atol=1e-4, rtol=1e-4)
    feats, hm, _, _, bev = out
    golden = np.load(os.path.join(GOLDEN, "lidar_model.npz"))
    assert_close("models.lidar.golden", feats[0, :4, :4],
                 golden["feats_slice"], atol=1e-4, rtol=1e-3)
    assert_close("models.lidar.golden", hm[0, :, :6, :6], golden["hm_slice"],
                 atol=1e-4, rtol=1e-3)
    assert_close("models.lidar.golden", bev.mean(dim=(2, 3)),
                 golden["bev_mean"], atol=1e-4, rtol=1e-3)


def test_seg_model_matches_jax(rng):
    params = JRgb.seg_model_init(jax.random.key(12), len(CFG.seg_channels))
    rgb = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    ref, _ = JRgb.seg_model_apply(params, jnp.asarray(rgb), False)
    model = _load(SegModel(len(TCFG.seg_channels)), params)
    with torch.no_grad():
        out = model(_t(rgb))
    assert_close("models.seg_model", out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("version", [1, 2])
def test_brake_model_matches_jax(rng, version):
    params = JRgb.brake_model_init(jax.random.key(13), 3, version=version)
    wide = rng.uniform(0, 255, (2, 32, 96, 3)).astype(np.float32)
    tel = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    ref, _ = JRgb.brake_model_apply(params, jnp.asarray(wide),
                                    jnp.asarray(tel), False, version=version)
    model = _load(BrakeModel(version), params)
    with torch.no_grad():
        out = model(_t(wide), _t(tel))
    assert_close(f"models.brake_model_v{version}", out, ref, atol=1e-5)


def _det(rng, K, H, W):
    x = rng.integers(0, W, K).astype(np.int32)
    y = rng.integers(0, H, K).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, K).astype(np.float32)
    valid = rng.uniform(size=K) > 0.3
    x[0], y[0] = W // 2, int(H / 2 + CFG.y_offset * H / 2)  # at the ego
    return dict(x=x, y=y, cos=np.cos(ang), sin=np.sin(ang), valid=valid)


@pytest.mark.parametrize("folded", [False, True])
def test_uniplanner_infer_matches_jax(rng, folded):
    """Against both lav_tpu forms: the CPU form (detection crops, then a
    separate ego crop) and the folded form the port always takes."""
    params = JPl.uniplanner_init(jax.random.key(14), CFG)
    core = _load(UniPlanner(TCFG), params)
    Hf = CFG.ny // 2
    feats = rng.normal(size=(Hf, Hf, CFG.uniplanner_input_channels)
                       ).astype(np.float32)
    K = CFG.max_det
    det = _det(rng, K, CFG.ny, CFG.nx)
    nxp = np.float32([4.0, 1.5])
    cmd = 2
    ref = JPl.uniplanner_infer(
        params, CFG, jnp.asarray(feats),
        {k: jnp.asarray(v) for k, v in det.items()}, jnp.asarray(cmd),
        jnp.asarray(nxp), use_pallas_crop=folded)
    with torch.no_grad():
        out = uniplanner_infer(
            core, TCFG, _t(feats)[None], {k: _t(v)[None]
                                          for k, v in det.items()},
            torch.tensor([cmd]), _t(nxp)[None])
    names = ("ego_plan_locs", "ego_cast_cmd_locs", "other_cast_locs",
             "other_cast_cmds")
    for name, o, r in zip(names, out[:4], ref[:4]):
        assert_close(f"models.uniplanner_infer.{name}", o[0], r, atol=1e-4,
                     rtol=1e-4)
    assert_close("models.uniplanner_infer.other_valid", out[4][0].int(),
                 np.asarray(ref[4]).astype(np.int32), atol=0.0)


def test_point_painting_matches_jax(rng):
    hw = (32, 40)
    rigs_j = [JPaint.CameraRig.build(y, lidar_xyz=(0, 0, 2.4),
                                     cam_xyz=(1.5, 0, 2.4), rgb_h=hw[0],
                                     rgb_w=hw[1], fov=64)
              for y in (-60, 0, 60)]
    rigs_t = [TPaint.CameraRig(*r) for r in rigs_j]
    E, N = 2, 400
    xyz = rng.uniform(-20, 20, (E, N, 3)).astype(np.float32)
    xyz[0, 0] = [1.0, 2.0, 1e12]       # projects far off every image
    valid = rng.uniform(size=(E, N)) > 0.1
    sems = rng.uniform(size=(E, 3, *hw, 4)).astype(np.float32)
    out = TPaint.point_painting(_t(xyz), _t(sems), rigs_t, valid=_t(valid))
    for e in range(E):
        ref = JPaint.point_painting(jnp.asarray(xyz[e]), jnp.asarray(sems[e]),
                                    rigs_j, valid=jnp.asarray(valid[e]))
        assert_close("ops.point_painting", out[e], ref, atol=0.0)
    assert (out[0, 0] == 0).all()
    assert (out.abs().sum(-1) > 0).float().mean() > 0.1


def test_det_inference_matches_jax(rng):
    H = W = 24
    hm = rng.uniform(size=(2, 2, H, W)).astype(np.float32) ** 4
    size = rng.uniform(0, 3, (2, 2, H, W)).astype(np.float32)
    ori = rng.uniform(-1, 1, (2, 2, H, W)).astype(np.float32)
    ego = (W / 2.0, H / 2.0 + 3.0)
    out = TPeak.det_inference(_t(hm), _t(size), _t(ori), pixels_per_meter=2,
                              max_det=6, min_score=0.1, ego_xy=ego)
    for b in range(2):
        ref = JPeak.det_inference(
            jnp.asarray(hm[b]), jnp.asarray(size[b]), jnp.asarray(ori[b]),
            pixels_per_meter=2, max_det=6, min_score=0.1,
            ego_xy=jnp.asarray(ego))
        v_ref = np.asarray(ref.valid)
        assert_close("ops.det_inference.valid", out.valid[b].int(),
                     v_ref.astype(np.int32), atol=0.0)
        for f in ("score", "x", "y", "w", "h", "cos", "sin"):
            o = getattr(out, f)[b].numpy()[v_ref]
            assert_close(f"ops.det_inference.{f}", o,
                         np.asarray(getattr(ref, f))[v_ref], atol=1e-6)


PROD_TOL = dict(atol=3e-2, rtol=3e-2)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def test_int8_lidar_model_matches_jax():
    """bf16 + int8 backbone and heads, with static scales; the four heads'
    scales are spread apart so that only their max (lav_tpu's merged
    heads quantize once) reproduces lav_tpu."""
    params = JQ.quantize_tree(JLid.lidar_model_init(
        jax.random.key(15), CFG.num_input, CFG.num_features))
    r = np.random.default_rng(15)
    pts = r.uniform(-5, 10, (2, 128, CFG.num_input - 5)).astype(np.float32)
    valid = r.uniform(size=(2, 128)) > 0.1
    kw = dict(train=False, num_features=CFG.num_features, **_geo(CFG))
    JQ.calibrate(lambda: JLid.lidar_model_apply(
        params, jnp.asarray(pts), jnp.asarray(valid), **kw))
    for i, h in enumerate(("center", "box", "ori", "seg")):
        conv = params[f"{h}_head"]["conv"]
        conv["x_scale"] = jnp.float32(conv["x_scale"] * (1.0 + 0.5 * i))
    ref = jax.jit(lambda p, x, v: JLid.lidar_model_apply(p, x, v, **kw))(
        params, _bf16(pts), jnp.asarray(valid))
    model = _load(LidarModel(TCFG.num_input, TCFG.num_features,
                             **_geo(TCFG)), params)
    with torch.no_grad():
        out = model(_t(pts).bfloat16(), _t(valid))
    names = ("features", "heatmap", "sizemap", "orimap", "bev_seg")
    for name, o, rf in zip(names, out, ref[:5]):
        assert o.dtype == (torch.float32 if name == "bev_seg"
                           else torch.bfloat16)
        assert_close(f"models.lidar_int8.{name}", o,
                     np.asarray(rf.astype(jnp.float32)), **PROD_TOL)


def test_int8_uniplanner_infer_matches_jax(monkeypatch):
    """bf16 features, int8 crop ResNet: the port emits int8 crops in the
    crop kernel's epilogue; lav_tpu's CPU form crops in bf16, then
    quantizes."""
    params = JQ.quantize_tree(JPl.uniplanner_init(jax.random.key(16), CFG))
    r = np.random.default_rng(16)
    Hf = CFG.ny // 2
    feats = r.normal(size=(Hf, Hf, CFG.uniplanner_input_channels)
                     ).astype(np.float32)
    det = {k: jnp.asarray(v) for k, v in _det(r, CFG.max_det, CFG.ny,
                                               CFG.nx).items()}
    nxp, cmd = jnp.float32([4.0, 1.5]), jnp.asarray(2)
    JQ.calibrate(lambda: JPl.uniplanner_infer(
        params, CFG, jnp.asarray(feats), det, cmd, nxp))
    ref = jax.jit(lambda p, f: JPl.uniplanner_infer(
        p, CFG, f, det, cmd, nxp))(params, _bf16(feats))
    core = _load(UniPlanner(TCFG), params)
    assert core.lidar_conv_emb.conv1.x_scale is not None
    q8_calls = []
    plain_q8 = TWarp.grid_sample_shared_q8
    monkeypatch.setattr(TWarp, "grid_sample_shared_q8",
                        lambda *a: q8_calls.append(1) or plain_q8(*a))
    with torch.no_grad():
        out = uniplanner_infer(
            core, TCFG, _t(feats).bfloat16()[None],
            {k: torch.from_numpy(np.array(v))[None] for k, v in det.items()},
            torch.tensor([2]), _t(np.asarray(nxp))[None])
    assert q8_calls == [1]
    names = ("ego_plan_locs", "ego_cast_cmd_locs", "other_cast_locs",
             "other_cast_cmds")
    for name, o, rf in zip(names, out[:4], ref[:4]):
        assert o.dtype == torch.float32
        assert_close(f"models.uniplanner_infer_int8.{name}", o[0],
                     np.asarray(rf), **PROD_TOL)


def test_camera_models_bf16_match_jax(rng):
    seg_p = JRgb.seg_model_init(jax.random.key(17), len(CFG.seg_channels))
    rgb = rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    ref, _ = JRgb.seg_model_apply(seg_p, _bf16(rgb), False)
    seg = _load(SegModel(len(TCFG.seg_channels)), seg_p)
    bra_p = JRgb.brake_model_init(jax.random.key(18), 3, version=2)
    wide = rng.uniform(0, 255, (2, 32, 96, 3)).astype(np.float32)
    tel = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    ref_b, _ = JRgb.brake_model_apply(bra_p, _bf16(wide), _bf16(tel), False,
                                      version=2)
    bra = _load(BrakeModel(2), bra_p)
    with torch.no_grad():
        out = seg(_t(rgb).bfloat16())
        out_b = bra(_t(wide).bfloat16(), _t(tel).bfloat16())
    assert out.dtype == torch.bfloat16
    assert_close("models.seg_model_bf16", out,
                 np.asarray(ref.astype(jnp.float32)), **PROD_TOL)
    # attention pooling promotes to f32, as lav_tpu's f32 query does
    assert out_b.dtype == torch.float32 and ref_b.dtype == jnp.float32
    assert_close("models.brake_model_v2_bf16", out_b, np.asarray(ref_b),
                 **PROD_TOL)
