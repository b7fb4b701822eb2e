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
leaf; the `BrakeModel` skips its auxiliary seg head.
Every other key must have a counterpart and every parameter and buffer
must be filled, or the load raises.  int8 leaves stay int8; every other
leaf is converted to f32.

`load_calibration` sets static activation scales from lav_tpu's
calibration JSON (`artifacts/calib/*.json`: lav_tpu param path -> scale).
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.quant import int8_convs


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
    missing = [name for name, t in list(module.named_parameters())
               + list(module.named_buffers()) if id(t) not in filled]
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
