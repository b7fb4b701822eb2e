"""lav_tpu_torch.nn.quant against lav_tpu.nn.quant on the CPU.

* `quantize_tree`: the same int8 weights and scales as lav_tpu's, exactly
  (both are per-output-channel absmax in f32 with round-half-to-even); on
  the v2 "mxu" models the quantized conv paths are the 39 keys of the
  committed calibration JSON.
* `conv2d_int8` (kernel `conv2d_int8`, whose plain version runs on CPU
  tensors) against lav_tpu's with int8 input, float input with a static
  scale and with a dynamic one: exact in f32 output (the int32 sum is
  exact and the dequantization takes the same f32 steps), within one bf16
  ulp in bf16.  The plain version's int32 sum is exact at the planner's
  7x7x384 depth with every partial sum far past 2^24.
* calibration: the port's f32 observer run of a tiny lidar model records
  the scales lav_tpu's does on the same input (rtol 1e-5: the two models'
  activations agree to f32 rounding).
* the variant routes' forms: `conv2d_int8_s2d` (lav_tpu's
  `LAV_S2D_CROPS=1`) against lav_tpu's, exact in f32 output, and against
  the port's direct conv on the same crops un-reshuffled, exact; the int8
  transposed conv (`LAV_INT8_UPCONV=1`) at the three upconv geometries
  against lav_tpu's `conv_transpose2d_int8`, exact in f32 (the int32 sums
  are exact) and within one bf16 ulp in bf16; `quantize_tree(include=
  r"^upconv\\d$")` picks lav_tpu's convs; the plain version's asymmetric
  padding and input dilation against `F.conv2d` on the zero-inserted input
  in f64, exact.
"""

import json
import pathlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.config import tiny_config
from lav_tpu.models import lidar as JLid
from lav_tpu.models import planner as JPl
from lav_tpu.nn import quant as JQ
from lav_tpu_torch.agent.agent import AgentModels
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.config import v2_config as t_v2_config
from lav_tpu_torch.models.lidar import LidarModel
from lav_tpu_torch.models.planner import UniPlanner
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn import quant as Q
from lav_tpu_torch.utils.weights import load_calibration, load_jax_params
from tests.torch_parity import assert_close

REPO = pathlib.Path(__file__).resolve().parents[1]
CALIB = REPO / "artifacts" / "calib" / "calib-d8158406a6645b7a9844bcb8.json"
CFG, TCFG = tiny_config(), t_tiny_config()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _geo(cfg):
    return dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
                max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)


def _jax_int8(tree, path=""):
    """{path: conv dict} of lav_tpu's int8 convs."""
    out = {}
    if isinstance(tree, dict):
        if "w_int8" in tree:
            out[path] = tree
        for k, v in tree.items():
            out.update(_jax_int8(v, f"{path}/{k}"))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_quantize_tree_matches_lav_tpu():
    lid = JLid.lidar_model_init(jax.random.key(0), CFG.num_input,
                                CFG.num_features)
    pl = JPl.uniplanner_init(jax.random.key(1), CFG)
    for tree, module in (
            (lid, LidarModel(TCFG.num_input, TCFG.num_features,
                             **_geo(TCFG))),
            (pl, UniPlanner(TCFG))):
        ref = _jax_int8(_np(JQ.quantize_tree(tree)))
        ref = {p: d for p, d in ref.items()
               if not p.startswith("/bev_planner")}   # not in the port
        load_jax_params(module, _np(tree))
        got = dict(Q.int8_convs(Q.quantize_tree(module)))
        assert set(got) == set(ref) and got
        for path, conv in got.items():
            w = np.asarray(ref[path]["w_int8"]).transpose(3, 0, 1, 2)
            np.testing.assert_array_equal(conv.w_int8.numpy(), w,
                                          err_msg=path)
            np.testing.assert_array_equal(conv.w_scale.numpy(),
                                          np.asarray(ref[path]["w_scale"]),
                                          err_msg=path)
            assert conv.w is None and conv.x_scale is None


def test_mxu_paths_are_the_calibration_keys():
    models = AgentModels(t_v2_config(), brake_version=2,
                         gen=torch.Generator().manual_seed(0))
    Q.quantize_tree(models.lidar_model)
    Q.quantize_tree(models.uniplanner)
    keys = json.loads(CALIB.read_text())
    paths = [p for p, _ in Q.int8_convs(models)]
    assert len(paths) == len(keys) == 39
    assert set(paths) == set(keys)
    load_calibration(models, CALIB)
    for path, conv in Q.int8_convs(models):
        assert conv.x_scale.dtype == torch.float32
        assert float(conv.x_scale) == np.float32(keys[path])
    with pytest.raises(KeyError):
        load_calibration(models, {"/lidar_model/backbone/conv1_0/conv": 1.0})


# (ksize, stride, padding, dilation, cin, bias)
CONVS = [(3, 1, 1, 1, 32, False), (7, 2, 3, 1, 48, False),
         (3, 2, 1, 1, 64, True), (1, 2, 0, 1, 32, False),
         (3, 1, 2, 2, 32, True)]
# (input, static scale, output)
MODES = [("int8", True, "bf16"), ("f32", True, "f32"), ("f32", False, "f32"),
         ("bf16", True, "bf16"), ("bf16", False, "bf16")]


@pytest.mark.parametrize("conv_case", CONVS)
@pytest.mark.parametrize("mode", MODES)
def test_conv2d_int8_matches_lav_tpu(conv_case, mode):
    k, s, p, d, cin, bias = conv_case
    x_kind, static, out_kind = mode
    r = np.random.default_rng(k * 100 + cin)
    cout = 16
    w = r.normal(size=(k, k, cin, cout)).astype(np.float32)
    jp = {"w": jnp.asarray(w)}
    if bias:
        jp["b"] = jnp.asarray(r.normal(size=cout).astype(np.float32))
    jp = JQ.quantize_conv(jp)
    xf = (r.normal(size=(2, 13, 11, cin)) * 3).astype(np.float32)
    if static:
        jp["x_scale"] = jnp.float32(np.abs(xf).max() / 127.0 * 0.8)
    if x_kind == "int8":
        x = r.integers(-127, 128, size=xf.shape).astype(np.int8)
    else:
        x = xf
    jx = jnp.asarray(x, jnp.bfloat16) if x_kind == "bf16" else jnp.asarray(x)
    ref = JQ.conv2d_int8(jp, jx, (s, s), ((p, p), (p, p)), (d, d))

    conv = L.Conv2d(cin, cout, k, s, p, d, bias=bias)
    load_jax_params(conv, _np(jp))
    tx = torch.from_numpy(x)
    if x_kind == "bf16":
        tx = tx.bfloat16()
    with torch.no_grad():
        out = Q.conv2d_int8(conv, tx)
        # through the module: NCHW in and out, the same numbers
        y = conv(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(y, out)
    assert out.dtype == {"f32": torch.float32, "bf16": torch.bfloat16}[
        out_kind]
    ref = np.asarray(ref.astype(jnp.float32))
    if out_kind == "f32":
        assert_close("quant.conv2d_int8.f32", out, ref, atol=0.0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        diff = np.abs(out.float().numpy() - ref)
        assert (diff <= ulp).all()
        assert_close("quant.conv2d_int8.bf16", out, ref,
                     atol=float(ulp.max()))


def test_conv2d_int8_plain_sum_is_exact():
    """Every product at +-127^2 and 7*7*384 of them: partial sums reach
    3.0e8, far past f32's 2^24; the chunked sum must still be exact."""
    r = np.random.default_rng(0)
    x = np.full((1, 9, 9, 384), 127, np.int8)
    x[..., ::5] = -127
    w = np.full((8, 7, 7, 384), 127, np.int8)
    w[1::2, :, :, ::5] = -127
    w[4:] = r.integers(-127, 128, size=w[4:].shape).astype(np.int8)
    one = torch.tensor(1.0)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.ones(8), one,
            None, (2, 2), (3, 3), (1, 1))
    acc = Q.conv2d_int8_plain(*args, torch.float32)
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(x).double().permute(0, 3, 1, 2),
        torch.from_numpy(w).double().permute(0, 3, 1, 2), None, 2, 3)
    ref = ref.permute(0, 2, 3, 1)
    assert float(ref.abs().max()) > 2.0 ** 28
    # float(acc) of the exact int32 sum is the f32 rounding of the exact
    # f64 sum; any error in the sum would move it
    assert torch.equal(acc, ref.float())
    exact = ref.to(torch.int64)
    small = exact.abs() < 2 ** 24
    assert torch.equal(acc.to(torch.int64)[small], exact[small])


def test_calibration_matches_lav_tpu():
    params = JLid.lidar_model_init(jax.random.key(4), CFG.num_input,
                                   CFG.num_features)
    pq = JQ.quantize_tree(params)
    r = np.random.default_rng(3)
    pts = r.uniform(-5, 10, (1, 128, CFG.num_input - 5)).astype(np.float32)
    valid = r.uniform(size=(1, 128)) > 0.1
    model = LidarModel(TCFG.num_input, TCFG.num_features, **_geo(TCFG))
    load_jax_params(model, _np(pq))
    JQ.calibrate(lambda: JLid.lidar_model_apply(
        pq, jnp.asarray(pts), jnp.asarray(valid), train=False,
        num_features=CFG.num_features, **_geo(CFG)))
    with torch.no_grad():
        Q.calibrate(model, torch.from_numpy(pts), torch.from_numpy(valid))
    ref = _jax_int8(pq)
    got = dict(Q.int8_convs(model))
    assert set(got) == set(ref)
    for path, conv in got.items():
        assert_close(f"quant.calibrate{path}", conv.x_scale,
                     np.asarray(ref[path]["x_scale"]), atol=0.0, rtol=1e-5)
    heads = [got[f"/{h}_head/conv"].x_scale
             for h in ("center", "box", "ori", "seg")]
    assert all(torch.equal(h, heads[0]) for h in heads)


UPCONV = r"^upconv\d$"


def test_quantize_tree_include_upconv_matches_lav_tpu():
    """At tiny widths (nf = 8) upconv1 has 8 input channels and stays
    float under min_channels=16, as in lav_tpu; upconv2/3 (16) turn int8,
    their int8 weight the flipped equivalent conv's kernel."""
    lid = JLid.lidar_model_init(jax.random.key(2), CFG.num_input,
                                CFG.num_features)
    ref = _jax_int8(_np(JQ.quantize_tree(lid, include=UPCONV)))
    module = LidarModel(TCFG.num_input, TCFG.num_features, **_geo(TCFG))
    load_jax_params(module, _np(lid))
    got = dict(Q.int8_convs(Q.quantize_tree(module, include=UPCONV)))
    assert set(got) == set(ref)
    ups = sorted(p for p in got if "upconv" in p)
    assert ups == ["/backbone/upconv2/conv", "/backbone/upconv3/conv"]
    for path in ups:
        conv = got[path]
        assert isinstance(conv, L.ConvTranspose2d)
        w = np.flip(np.asarray(ref[path]["w_int8"]), (0, 1))
        np.testing.assert_array_equal(conv.w_int8.numpy(),
                                      w.transpose(3, 0, 1, 2), err_msg=path)
        np.testing.assert_array_equal(conv.w_scale.numpy(),
                                      np.asarray(ref[path]["w_scale"]))
    heads_up = [m for n, m in module.named_modules() if n.endswith(".up")]
    assert heads_up and all(m.w_int8 is None for m in heads_up)


@pytest.mark.parametrize("out_kind", ["f32", "bf16"])
def test_conv2d_int8_s2d_matches_lav_tpu(out_kind):
    r = np.random.default_rng(31)
    C, O = 32, 16
    jp = JQ.quantize_conv({"w": jnp.asarray(r.normal(size=(7, 7, C, O))
                                            .astype(np.float32)),
                           "b": jnp.asarray(r.normal(size=O)
                                            .astype(np.float32))})
    jp["x_scale"] = jnp.float32(0.03)
    x = r.integers(-127, 128, size=(2, 10, 12, 4 * C)).astype(np.int8)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[out_kind]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[out_kind]
    ref = np.asarray(JQ.conv2d_int8_s2d(jp, jnp.asarray(x), jdt)
                     .astype(jnp.float32))
    conv = L.Conv2d(C, O, 7, 2, 3, bias=True)
    load_jax_params(conv, _np(jp))
    with torch.no_grad():
        out = Q.conv2d_int8_s2d(conv, torch.from_numpy(x), tdt)
    assert out.dtype == tdt and out.shape == ref.shape == (2, 10, 12, O)
    if out_kind == "f32":
        assert_close("quant.conv2d_int8_s2d", out, ref, atol=0.0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= ulp).all()


def test_s2d_conv_equals_direct_conv_on_the_crops():
    """The 4x4 stride-1 conv over space-to-depth crops and the direct 7x7
    stride-2 conv over the crops themselves sum the same int32 products:
    equal, through ResNet's conv1 dispatch too."""
    from lav_tpu_torch.core.warp import space_to_depth
    from lav_tpu_torch.nn.resnet import ResNet

    r = np.random.default_rng(32)
    net = ResNet((1, 1, 1, 1), num_channels=48, width=16,
                 gen=torch.Generator().manual_seed(3)).eval()
    Q.quantize_tree(net)
    net.conv1.x_scale = torch.tensor(0.02)
    crops = torch.from_numpy(r.integers(-127, 128, size=(3, 16, 16, 48))
                             .astype(np.int8))
    s2d = space_to_depth(crops[None])[0]
    assert s2d.shape == (3, 8, 8, 192)
    direct = Q.conv2d_int8(net.conv1, crops)
    assert torch.equal(Q.conv2d_int8_s2d(net.conv1, s2d), direct)
    with torch.no_grad():
        a = net(L.nhwc_to_nchw(crops))
        b = net(L.nhwc_to_nchw(s2d))
    assert torch.equal(a, b)


# (ksize, stride, padding, output_padding, H): lav_tpu's three upconvs
UPCONVS = [(1, 1, 0, 0, 12), (4, 2, 1, 0, 6), (4, 4, 1, 2, 3)]


@pytest.mark.parametrize("x_kind", ["f32", "bf16"])
@pytest.mark.parametrize("geom", UPCONVS)
def test_conv_transpose2d_int8_matches_lav_tpu(geom, x_kind):
    k, s, p, op, H = geom
    C, O = 32, 24
    r = np.random.default_rng(33 + k * 10 + s)
    jp = JQ.quantize_conv({"w": jnp.asarray(r.normal(size=(k, k, C, O))
                                            .astype(np.float32))})
    x = (r.normal(size=(2, H, H + 1, C)) * 2).astype(np.float32)
    jp["x_scale"] = jnp.float32(np.abs(x).max() / 127.0 * 0.9)
    jx = jnp.asarray(x, jnp.bfloat16) if x_kind == "bf16" else jnp.asarray(x)
    conv_pad = ((k - 1 - p, k - 1 - p + op), (k - 1 - p, k - 1 - p + op))
    ref = np.asarray(JQ.conv_transpose2d_int8(jp, jx, conv_pad, (s, s))
                     .astype(jnp.float32))
    conv = L.ConvTranspose2d(C, O, k, s, p, op, bias=False)
    load_jax_params(conv, _np(jp))
    tx = torch.from_numpy(x)
    if x_kind == "bf16":
        tx = tx.bfloat16()
    with torch.no_grad():
        out = conv(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, (H - 1) * s - 2 * p + k + op,
                                      H * s - 2 * p + k + op, O)
    if x_kind == "f32":
        assert out.dtype == torch.float32
        assert_close("quant.conv_transpose2d_int8", out, ref, atol=0.0)
    else:
        assert out.dtype == torch.bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out.float().numpy() - ref) <= ulp).all()
        assert_close("quant.conv_transpose2d_int8.bf16", out, ref,
                     atol=float(ulp.max()))


@pytest.mark.parametrize("pads,lhs", [
    (((2, 1), (2, 1)), (1, 1)),     # the s2d conv1's
    (((2, 2), (2, 2)), (2, 2)),     # upconv2's
    (((2, 4), (2, 4)), (4, 4)),     # upconv3's
    (((0, 3), (1, 0)), (3, 2)),
])
def test_conv2d_int8_plain_asymmetric_padding_and_input_dilation(pads, lhs):
    r = np.random.default_rng(34)
    x = r.integers(-127, 128, size=(2, 5, 6, 8)).astype(np.int8)
    w = r.integers(-127, 128, size=(4, 3, 4, 8)).astype(np.int8)
    acc = Q.conv2d_int8_plain(torch.from_numpy(x), torch.from_numpy(w),
                              torch.ones(4), torch.tensor(1.0), None,
                              (1, 2), pads, (1, 1), torch.float32, lhs)
    xd = np.zeros((2, (5 - 1) * lhs[0] + 1, (6 - 1) * lhs[1] + 1, 8))
    xd[:, ::lhs[0], ::lhs[1]] = x
    xd = np.pad(xd, ((0, 0), pads[0], pads[1], (0, 0)))
    ref = torch.nn.functional.conv2d(
        torch.from_numpy(xd).permute(0, 3, 1, 2),
        torch.from_numpy(w).double().permute(0, 3, 1, 2), None, (1, 2))
    ref = ref.permute(0, 2, 3, 1)
    assert acc.shape == ref.shape
    assert torch.equal(acc, ref.float())


def test_conv2d_int8_wrapper_refuses_meta():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    w = torch.zeros((8, 3, 3, 32), dtype=torch.int8)
    args = (torch.ones(8), torch.tensor(1.0), None, (1, 1), ((2, 1), (1, 2)),
            (1, 1), torch.float32)
    out = Q.conv2d_int8_nhwc(x, w, *args, lhs_dilation=(2, 2))
    assert out.shape == (1, 8, 8, 8)
    with pytest.raises(ValueError):
        Q.conv2d_int8_nhwc(x.to("meta"), w.to("meta"), *args,
                           lhs_dilation=(2, 2))
