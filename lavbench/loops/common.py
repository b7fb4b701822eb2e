"""What the loops share: configurations, dtypes, tensor trees."""

from __future__ import annotations

import dataclasses
import time

import torch

from lavbench.ref.config import LAVConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def take(tree, idx):
    """`tree` (tensors, named tuples, dicts, lists) with every tensor's
    leading axis indexed by `idx`."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    if isinstance(tree, dict):
        return {k: take(v, idx) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(take(v, idx) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(take(v, idx) for v in tree)
    return tree


def rel(p, r, dim=None) -> torch.Tensor:
    """Relative error |p - r| / |r| by the 2-norm, per leading index when
    `dim` is given (the norm over every other axis)."""
    p, r = p.double(), r.double()
    if dim is None:
        return (p - r).norm() / r.norm().clamp_min(1e-30)
    p, r = p.flatten(1), r.flatten(1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Phases:
    """Wall seconds of the set-up's phases, each up to the end of its work
    on the device: `phases(name)` closes the phase `name`."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.t = time.perf_counter()
        self.spent = {}

    def __call__(self, name: str) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.spent[name] = now - self.t
        self.t = now


def model_fields(config: dict) -> dict:
    """The LAVConfig fields of a configuration file."""
    names = {f.name for f in dataclasses.fields(LAVConfig)}
    return {k: v for k, v in config.items() if k in names}
