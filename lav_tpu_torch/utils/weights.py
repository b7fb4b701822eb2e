"""Load a lav_tpu params pytree into the port's modules.

The tree is given as nested dicts of numpy arrays (the caller converts
JAX arrays with `np.asarray`; nothing here imports jax).  Module and
parameter names equal the tree's keys, so the walk is structural; each
leaf layer converts its arrays to PyTorch's layout:

  Linear          w (in, out)            -> (out, in)
  Conv2d          w HWIO (kh, kw, i, o)  -> OIHW; or lav_tpu's int8 form
                  (nn/quant.py): w_int8 HWIO int8 -> OHWI, w_scale (o,),
                  x_scale () when calibrated, and the conv turns int8
  ConvTranspose2d w HWIO of the flipped equivalent conv -> (i, o, kh, kw);
                  or int8 (`include=r"^upconv\\d$"`): w_int8 HWIO -> the
                  flipped equivalent conv's OHWI, w_scale, x_scale
  BatchNorm       scale, bias, mean, var -> as they are
  GRU             w_ih (I, 3H), w_hh (H, 3H) -> (3H, I), (3H, H);
                  gate order (r, z, n) is torch's already
  GRUBank         the stacked (n, ...) forms of the GRU arrays
  LinearBank      w (n, in, out)         -> (n, out, in)

Keys a module lists in `jax_unused` (training-only parts) are skipped:
an inference `UniPlanner` skips the teacher `bev_planner` and the
never-evaluated `other` cast bank, which `UniPlanner(cfg, teacher=True)`
(the distillation step's, `train/distill.py`) loads like every other
leaf.  Every other key must have a counterpart and every parameter and
persistent buffer must be filled, or the load raises (a non-persistent
buffer, such as the `BrakeModel`'s normalisation constants, is no
lav_tpu param).  int8 leaves stay int8; every other leaf is converted to
f32.

`load_calibration` sets static activation scales from lav_tpu's
calibration JSON (`artifacts/calib/*.json`: lav_tpu param path -> scale).

The converters between LAV's PyTorch state_dicts (numpy arrays under
LAV's module names) and lav_tpu's params trees are a copy of lav_tpu's:
`convert_*` (resnet in torchvision's layout, erfnet, seg model, brake
model, lidar model, BEV planner, UniPlanner), `export_*` (resnet and both
planners, the inverse) and `load_torch_state_dict`.  A LAV `.th`
checkpoint loads into the port's modules as
`load_jax_params(module, convert_*(load_torch_state_dict(path)))`.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.quant import int8_convs

Array = np.ndarray
SD = Dict[str, Array]


def _set(t: torch.Tensor, arr, path: str, filled: set) -> None:
    arr = np.asarray(arr)
    if (t.dtype == torch.int8) != (arr.dtype == np.int8):
        raise TypeError(f"{path}: lav_tpu {arr.dtype} for a {t.dtype} "
                        "tensor")
    a = torch.from_numpy(np.array(arr, dtype=arr.dtype if arr.dtype ==
                                  np.int8 else np.float32, copy=True))
    if tuple(a.shape) != tuple(t.shape):
        raise ValueError(f"{path}: lav_tpu shape {tuple(a.shape)} does not "
                         f"convert to {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(a.to(t.dtype))
    filled.add(id(t))


def _linear(m, d, path, filled):
    _set(m.w, np.asarray(d["w"]).T, path + "/w", filled)
    if m.b is not None:
        _set(m.b, d["b"], path + "/b", filled)


def _int8_leaf(m, d, w_ohwi, path, filled):
    """Switch conv `m` to int8 and fill it from lav_tpu's dict `d`, the
    int8 weight already in the port's (O, KH, KW, I) layout."""
    kh, kw = m.ksize
    m.quantize_(torch.empty((m.cout, kh, kw, m.cin), dtype=torch.int8),
                torch.empty((m.cout,)))
    _set(m.w_int8, w_ohwi, path + "/w_int8", filled)
    _set(m.w_scale, d["w_scale"], path + "/w_scale", filled)
    if "x_scale" in d:
        m.x_scale = torch.empty(())
        _set(m.x_scale, d["x_scale"], path + "/x_scale", filled)


def _conv(m, d, path, filled):
    if "w_int8" in d:
        _int8_leaf(m, d, np.asarray(d["w_int8"]).transpose(3, 0, 1, 2), path,
                   filled)
    else:
        _set(m.w, np.asarray(d["w"]).transpose(3, 2, 0, 1), path + "/w",
             filled)
    if m.b is not None:
        _set(m.b, d["b"], path + "/b", filled)


def _conv_transpose(m, d, path, filled):
    if "w_int8" in d:   # lav_tpu flips at apply time; the port stores it so
        w = np.flip(np.asarray(d["w_int8"]), (0, 1)).transpose(3, 0, 1, 2)
        _int8_leaf(m, d, w, path, filled)
    else:
        _set(m.w, np.asarray(d["w"]).transpose(2, 3, 0, 1), path + "/w",
             filled)
    if m.b is not None:
        _set(m.b, d["b"], path + "/b", filled)


def _batchnorm(m, d, path, filled):
    for k in ("scale", "bias", "mean", "var"):
        _set(getattr(m, k), d[k], f"{path}/{k}", filled)


def _gru(m, d, path, filled):
    _set(m.w_ih, np.asarray(d["w_ih"]).swapaxes(-1, -2), path + "/w_ih",
         filled)
    _set(m.w_hh, np.asarray(d["w_hh"]).swapaxes(-1, -2), path + "/w_hh",
         filled)
    _set(m.b_ih, d["b_ih"], path + "/b_ih", filled)
    _set(m.b_hh, d["b_hh"], path + "/b_hh", filled)


def _linear_bank(m, d, path, filled):
    _set(m.w, np.asarray(d["w"]).swapaxes(-1, -2), path + "/w", filled)
    _set(m.b, d["b"], path + "/b", filled)


_LEAVES = {
    L.Linear: _linear,
    L.Conv2d: _conv,
    L.ConvTranspose2d: _conv_transpose,
    L.BatchNorm: _batchnorm,
    L.GRU: _gru,
    L.GRUBank: _gru,
    L.LinearBank: _linear_bank,
}


def _walk(module: nn.Module, tree, path: str, filled: set) -> None:
    leaf = _LEAVES.get(type(module))
    if leaf is not None:
        leaf(module, tree, path, filled)
        return
    unused = set(getattr(module, "jax_unused", ()))
    children = dict(module.named_children())
    params = dict(module.named_parameters(recurse=False))
    for key, val in tree.items():
        if key in unused:
            continue
        if key in children:
            _walk(children[key], val, f"{path}/{key}", filled)
        elif key in params:
            _set(params[key], val, f"{path}/{key}", filled)
        else:
            raise KeyError(f"{path}/{key}: no counterpart in "
                           f"{type(module).__name__}")


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Fill `module` from the lav_tpu params `tree`; returns the module."""
    filled: set = set()
    _walk(module, tree, "", filled)
    missing = [name for name, t in module.state_dict(keep_vars=True).items()
               if id(t) not in filled]
    if missing:
        raise KeyError(f"lav_tpu params leave these unset: {missing[:8]}")
    return module


def load_calibration(module: nn.Module, scales) -> nn.Module:
    """Set each int8 conv's static `x_scale` from `scales`, a dict or the
    path of a JSON file mapping lav_tpu param paths rooted at `module`
    (e.g. '/uniplanner/lidar_conv_emb/conv1' for the agent's models) to
    floats.  Raises if a key names no int8 conv."""
    if not isinstance(scales, dict):
        with open(scales) as f:
            scales = json.load(f)
    convs = dict(int8_convs(module))
    unknown = sorted(set(scales) - set(convs))
    if unknown:
        raise KeyError(f"calibration keys with no int8 conv: {unknown[:8]}")
    for path, val in scales.items():
        conv = convs[path]
        conv.x_scale = torch.tensor(float(val), dtype=torch.float32,
                                    device=conv.w_scale.device)
    return module


# ---------------------------------------------------------------------------
# LAV state_dicts <-> lav_tpu params trees (a copy of lav_tpu's converters)
# ---------------------------------------------------------------------------

def _sd_conv(sd: SD, name: str, bias: bool = True):
    p = {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _sd_convT(sd: SD, name: str, bias: bool = True):
    p = {"w": sd[f"{name}.weight"].transpose(2, 3, 0, 1)}
    if bias and f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _sd_bn(sd: SD, name: str):
    return {
        "scale": sd[f"{name}.weight"],
        "bias": sd[f"{name}.bias"],
        "mean": sd[f"{name}.running_mean"],
        "var": sd[f"{name}.running_var"],
    }


def _sd_linear(sd: SD, name: str):
    p = {"w": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _sd_gru(sd: SD, name: str):
    return {
        "w_ih": sd[f"{name}.weight_ih_l0"].T,
        "w_hh": sd[f"{name}.weight_hh_l0"].T,
        "b_ih": sd[f"{name}.bias_ih_l0"],
        "b_hh": sd[f"{name}.bias_hh_l0"],
    }


def _stack(dicts):
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}


# ---------------------------------------------------------------------------
# ResNet (torchvision layout, reference lav/models/resnet.py)
# ---------------------------------------------------------------------------

def convert_resnet(sd: SD, prefix: str = "",
                   layers_cfg: Sequence[int] = (2, 2, 2, 2)):
    p = {
        "conv1": _sd_conv(sd, f"{prefix}conv1", bias=False),
        "bn1": _sd_bn(sd, f"{prefix}bn1"),
    }
    for stage, blocks in enumerate(layers_cfg):
        for b in range(blocks):
            t = f"{prefix}layer{stage + 1}.{b}"
            blk = {
                "conv1": _sd_conv(sd, f"{t}.conv1", bias=False),
                "bn1": _sd_bn(sd, f"{t}.bn1"),
                "conv2": _sd_conv(sd, f"{t}.conv2", bias=False),
                "bn2": _sd_bn(sd, f"{t}.bn2"),
            }
            if f"{t}.downsample.0.weight" in sd:
                blk["down_conv"] = _sd_conv(sd, f"{t}.downsample.0", bias=False)
                blk["down_bn"] = _sd_bn(sd, f"{t}.downsample.1")
            p[f"layer{stage + 1}_{b}"] = blk
    return p


# ---------------------------------------------------------------------------
# ERFNet (reference lav/models/erfnet.py)
# ---------------------------------------------------------------------------

def _downsampler(sd: SD, prefix: str):
    return {"conv": _sd_conv(sd, f"{prefix}.conv"), "bn": _sd_bn(sd, f"{prefix}.bn")}


def _non_bt(sd: SD, prefix: str):
    return {
        "conv3x1_1": _sd_conv(sd, f"{prefix}.conv3x1_1"),
        "conv1x3_1": _sd_conv(sd, f"{prefix}.conv1x3_1"),
        "bn1": _sd_bn(sd, f"{prefix}.bn1"),
        "conv3x1_2": _sd_conv(sd, f"{prefix}.conv3x1_2"),
        "conv1x3_2": _sd_conv(sd, f"{prefix}.conv1x3_2"),
        "bn2": _sd_bn(sd, f"{prefix}.bn2"),
    }


def _upsampler(sd: SD, prefix: str):
    return {"conv": _sd_convT(sd, f"{prefix}.conv"), "bn": _sd_bn(sd, f"{prefix}.bn")}


def convert_erfnet(sd: SD, prefix: str = ""):
    # encoder.layers: 0 = down(16,64), 1-5 nb, 6 = down(64,128), 7-14 nb;
    # our enc_i == encoder.layers.(i+1)
    p = {
        "initial": _downsampler(sd, f"{prefix}encoder.initial_block"),
        "enc_down0": _downsampler(sd, f"{prefix}encoder.layers.0"),
    }
    for i in range(14):
        src = f"{prefix}encoder.layers.{i + 1}"
        p[f"enc_{i}"] = (_downsampler(sd, src) if i == 5 else _non_bt(sd, src))
    # decoder.layers: 0 up, 1-2 nb, 3 up, 4-5 nb
    for i, kind in enumerate(["up", "nb", "nb", "up", "nb", "nb"]):
        src = f"{prefix}decoder.layers.{i}"
        p[f"dec_{i}"] = (_upsampler(sd, src) if kind == "up" else _non_bt(sd, src))
    p["output_conv"] = _sd_convT(sd, f"{prefix}decoder.output_conv")
    return p


def convert_seg_model(sd: SD):
    return {"erfnet": convert_erfnet(sd, "erfnet.")}


# ---------------------------------------------------------------------------
# Brake model (reference lav/models/rgb.py:47-78, rgb_v2.py:48-82)
# ---------------------------------------------------------------------------

def convert_brake_model(sd: SD, version: int = 1):
    p = {
        "conv_backbone": convert_resnet(sd, "conv_backbone."),
        "seg_head": {
            "up1": _sd_convT(sd, "seg_head.upconv.0"),
            "bn1": _sd_bn(sd, "seg_head.upconv.1"),
            "up2": _sd_convT(sd, "seg_head.upconv.3"),
            "bn2": _sd_bn(sd, "seg_head.upconv.4"),
            "up3": _sd_convT(sd, "seg_head.upconv.6"),
            "bn3": _sd_bn(sd, "seg_head.upconv.7"),
            "out": _sd_conv(sd, "seg_head.upconv.9"),
        },
        "classifier": _sd_linear(sd, "classifier.0"),
    }
    if version == 2:
        for i in (1, 2):
            p[f"attn{i}"] = {
                "q": sd[f"attn{i}.q"],
                "linear_kv": _sd_linear(sd, f"attn{i}.linear_kv"),
            }
    return p


# ---------------------------------------------------------------------------
# LiDARModel (reference lav/models/lidar.py, point_pillar.py)
# ---------------------------------------------------------------------------

def convert_lidar_model(sd: SD, num_features: Sequence[int] = (32, 32)):
    pp = {}
    for i in range(len(num_features)):
        # point_net.net = [Linear, BN1d, ReLU] * n
        pp[f"linear_{i}"] = _sd_linear(sd, f"point_pillar_net.point_net.net.{3 * i}")
        pp[f"bn_{i}"] = _sd_bn(sd, f"point_pillar_net.point_net.net.{3 * i + 1}")

    bb = {}
    stages = ((4, "conv1"), (6, "conv2"), (6, "conv3"))
    for s, (n_convs, tname) in enumerate(stages):
        for b in range(n_convs):
            # Sequential of [Conv, ReLU, BN] triplets
            bb[f"conv{s + 1}_{b}"] = {
                "conv": _sd_conv(sd, f"backbone.{tname}.{3 * b}", bias=False),
                "bn": _sd_bn(sd, f"backbone.{tname}.{3 * b + 2}"),
            }
    for i in (1, 2, 3):
        bb[f"upconv{i}"] = {
            "conv": _sd_convT(sd, f"backbone.upconv{i}.0", bias=False),
            "bn": _sd_bn(sd, f"backbone.upconv{i}.2"),
        }

    def head(name):
        return {
            "conv": _sd_conv(sd, f"{name}.net.0", bias=False),
            "bn": _sd_bn(sd, f"{name}.net.2"),
            "up": _sd_convT(sd, f"{name}.net.3"),
        }

    return {
        "point_pillar": pp,
        "backbone": bb,
        "center_head": head("center_head"),
        "box_head": head("box_head"),
        "ori_head": head("ori_head"),
        "seg_head": head("seg_head"),
    }


# ---------------------------------------------------------------------------
# Planners (reference lav/models/bev_planner.py, uniplanner.py)
# ---------------------------------------------------------------------------

def _planner_core(sd: SD, prefix: str, num_cmds: int, ego_suffix: str = "",
                  with_other_bank: bool = False):
    p = {
        "plan_gru": _sd_gru(sd, f"{prefix}plan_gru"),
        "plan_mlp": _sd_linear(sd, f"{prefix}plan_mlp"),
        "cast_grus": _stack([
            _sd_gru(sd, f"{prefix}cast_grus{ego_suffix}.{i}") for i in range(num_cmds)
        ]),
        "cast_mlps": _stack([
            _sd_linear(sd, f"{prefix}cast_mlps{ego_suffix}.{i}") for i in range(num_cmds)
        ]),
        "cast_cmd_pred": _sd_linear(sd, f"{prefix}cast_cmd_pred.0"),
    }
    if with_other_bank:
        p["cast_grus_other"] = _stack([
            _sd_gru(sd, f"{prefix}cast_grus_other.{i}") for i in range(num_cmds)
        ])
        p["cast_mlps_other"] = _stack([
            _sd_linear(sd, f"{prefix}cast_mlps_other.{i}") for i in range(num_cmds)
        ])
    return p


def convert_bev_planner(sd: SD, num_cmds: int = 6):
    p = {"bev_conv_emb": convert_resnet(sd, "bev_conv_emb.0.")}
    p.update(_planner_core(sd, "", num_cmds))
    return p


def convert_uniplanner(sd: SD, num_cmds: int = 6,
                       include_teacher: bool = True):
    p = {"lidar_conv_emb": convert_resnet(sd, "lidar_conv_emb.0.")}
    p.update(
        _planner_core(sd, "", num_cmds, ego_suffix="_ego", with_other_bank=True)
    )
    if include_teacher and "bev_planner.plan_gru.weight_ih_l0" in sd:
        tp = {"bev_conv_emb": convert_resnet(sd, "bev_planner.bev_conv_emb.0.")}
        tp.update(_planner_core(sd, "bev_planner.", num_cmds))
        p["bev_planner"] = tp
    return p


# ---------------------------------------------------------------------------
# inverse direction: lav_tpu params -> reference-format state dicts
# (lets models trained here drop into the reference's torch stack)
# ---------------------------------------------------------------------------

def _inv_conv(sd: SD, name: str, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _inv_convT(sd: SD, name: str, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(2, 3, 0, 1)
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _inv_bn(sd: SD, name: str, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])
    sd[f"{name}.running_mean"] = np.asarray(p["mean"])
    sd[f"{name}.running_var"] = np.asarray(p["var"])


def _inv_linear(sd: SD, name: str, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _inv_gru(sd: SD, name: str, p, idx=None):
    sel = (lambda x: np.asarray(x)[idx]) if idx is not None else np.asarray
    sd[f"{name}.weight_ih_l0"] = sel(p["w_ih"]).T
    sd[f"{name}.weight_hh_l0"] = sel(p["w_hh"]).T
    sd[f"{name}.bias_ih_l0"] = sel(p["b_ih"])
    sd[f"{name}.bias_hh_l0"] = sel(p["b_hh"])


def export_resnet(sd: SD, prefix: str, p,
                  layers_cfg: Sequence[int] = (2, 2, 2, 2)):
    _inv_conv(sd, f"{prefix}conv1", p["conv1"])
    _inv_bn(sd, f"{prefix}bn1", p["bn1"])
    for stage, blocks in enumerate(layers_cfg):
        for b in range(blocks):
            blk = p[f"layer{stage + 1}_{b}"]
            t = f"{prefix}layer{stage + 1}.{b}"
            _inv_conv(sd, f"{t}.conv1", blk["conv1"])
            _inv_bn(sd, f"{t}.bn1", blk["bn1"])
            _inv_conv(sd, f"{t}.conv2", blk["conv2"])
            _inv_bn(sd, f"{t}.bn2", blk["bn2"])
            if "down_conv" in blk:
                _inv_conv(sd, f"{t}.downsample.0", blk["down_conv"])
                _inv_bn(sd, f"{t}.downsample.1", blk["down_bn"])
    return sd


def _export_planner_core(sd: SD, prefix: str, p, num_cmds: int,
                         ego_suffix: str = ""):
    _inv_gru(sd, f"{prefix}plan_gru", p["plan_gru"])
    _inv_linear(sd, f"{prefix}plan_mlp", p["plan_mlp"])
    for i in range(num_cmds):
        _inv_gru(sd, f"{prefix}cast_grus{ego_suffix}.{i}", p["cast_grus"], i)
        m = {k: np.asarray(v)[i] for k, v in p["cast_mlps"].items()}
        _inv_linear(sd, f"{prefix}cast_mlps{ego_suffix}.{i}", m)
    _inv_linear(sd, f"{prefix}cast_cmd_pred.0", p["cast_cmd_pred"])
    if "cast_grus_other" in p:
        for i in range(num_cmds):
            _inv_gru(sd, f"{prefix}cast_grus_other.{i}", p["cast_grus_other"], i)
            m = {k: np.asarray(v)[i] for k, v in p["cast_mlps_other"].items()}
            _inv_linear(sd, f"{prefix}cast_mlps_other.{i}", m)
    return sd


def export_bev_planner(p, num_cmds: int = 6) -> SD:
    sd: SD = {}
    export_resnet(sd, "bev_conv_emb.0.", p["bev_conv_emb"])
    return _export_planner_core(sd, "", p, num_cmds)


def export_uniplanner(p, num_cmds: int = 6) -> SD:
    sd: SD = {}
    export_resnet(sd, "lidar_conv_emb.0.", p["lidar_conv_emb"])
    _export_planner_core(sd, "", p, num_cmds, ego_suffix="_ego")
    if "bev_planner" in p:
        export_resnet(sd, "bev_planner.bev_conv_emb.0.",
                      p["bev_planner"]["bev_conv_emb"])
        _export_planner_core(sd, "bev_planner.", p["bev_planner"], num_cmds)
    return sd


def load_torch_state_dict(path: str) -> SD:
    """Load a LAV .th checkpoint (a state_dict) into numpy arrays."""
    sd = torch.load(path, map_location="cpu")
    return {k: v.detach().numpy() for k, v in sd.items()}
