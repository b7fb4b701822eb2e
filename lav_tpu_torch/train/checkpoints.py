"""Checkpoints: params and optimizer state saved with torch.save
(counterpart of `lav_tpu/train/checkpoints.py`).

A training snapshot is lav_tpu's tree, {'params', 'opt_state', 'epoch',
'it'}: the models' state_dict (BN running statistics included), the
optimizer's state (`train/distill.py::MultiSteps.state_dict`: Adam's
moments, the learning-rate schedule's count, which optax keeps in its
opt_state, and a partial gradient mean), and the position, so that a
resumed stage restores all of it.  Each stage loads the previous stage's
weights by a config path (`load_params`), which accepts a snapshot or a
bare state_dict.
"""

from __future__ import annotations

import os

import torch


def snapshot(models, optimizer, epoch: int, it: int) -> dict:
    """The training snapshot of `models` and `optimizer` at a position."""
    return dict(params=models.state_dict(), opt_state=optimizer.state_dict(),
                epoch=int(epoch), it=int(it))


def save_checkpoint(path: str, tree) -> str:
    """torch.save `tree` (a snapshot or a bare state_dict) to `path`,
    through a temporary file, so that a reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, models=None, optimizer=None) -> dict:
    """The snapshot at `path`, its tensors on the CPU; loads its params into
    `models` and its optimizer state into `optimizer` where given."""
    snap = torch.load(os.path.abspath(path), map_location="cpu")
    if models is not None:
        models.load_state_dict(snap["params"])
    if optimizer is not None:
        optimizer.load_state_dict(snap["opt_state"])
    return snap


def _is_snapshot(tree) -> bool:
    return isinstance(tree, dict) and {"params", "opt_state", "epoch",
                                       "it"} <= set(tree)


def load_params(path: str, module):
    """Stage-pointer loading: the params of a training snapshot, or a bare
    state_dict, into `module`; returns the module."""
    tree = torch.load(os.path.abspath(path), map_location="cpu")
    module.load_state_dict(tree["params"] if _is_snapshot(tree) else tree)
    return module
