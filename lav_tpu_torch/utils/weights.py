"""Load a lav_tpu params pytree into the port's modules.

The tree is given as nested dicts of numpy arrays (the caller converts
JAX arrays with `np.asarray`; nothing here imports jax).  Module and
parameter names equal the tree's keys, so the walk is structural; each
leaf layer converts its arrays to PyTorch's layout:

  Linear          w (in, out)            -> (out, in)
  Conv2d          w HWIO (kh, kw, i, o)  -> OIHW
  ConvTranspose2d w HWIO of the flipped equivalent conv -> (i, o, kh, kw)
  BatchNorm       scale, bias, mean, var -> as they are
  GRU             w_ih (I, 3H), w_hh (H, 3H) -> (3H, I), (3H, H);
                  gate order (r, z, n) is torch's already
  GRUBank         the stacked (n, ...) forms of the GRU arrays
  LinearBank      w (n, in, out)         -> (n, out, in)

Keys a module lists in `jax_unused` (training-only parts) are skipped.
Every other key must have a counterpart and every parameter and buffer
must be filled, or the load raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from lav_tpu_torch.nn import layers as L


def _set(t: torch.Tensor, arr, path: str, filled: set) -> None:
    a = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
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


def _conv(m, d, path, filled):
    _set(m.w, np.asarray(d["w"]).transpose(3, 2, 0, 1), path + "/w", filled)
    if m.b is not None:
        _set(m.b, d["b"], path + "/b", filled)


def _conv_transpose(m, d, path, filled):
    _set(m.w, np.asarray(d["w"]).transpose(2, 3, 0, 1), path + "/w", filled)
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
