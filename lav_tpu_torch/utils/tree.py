"""BatchNorm running statistics of a train step (counterpart of
`lav_tpu/utils/tree.py`).

lav_tpu's apply functions return a state tree of updated BN statistics,
and the train step writes it into the params once, after the optimizer
step.  Here each train-mode `BatchNorm` keeps its update in `new_stats`;
`bn_state` reads them and `merge_bn_state` writes them into the running
statistics.  A module called twice in one step keeps its last call's
update, each computed from the statistics of before the step.
`checkpoint` recomputes a part of the forward in the backward pass
without letting the recompute change those updates.  The recompute
carries the `torch.profiler` label its caller names (the distillation
step's `distill/backward/recompute/lidar`, `/planner` and `/crops`); it
runs on the thread that runs the backward, autograd's device thread for
a loss on a card, under that pass's `distill/backward`
(`utils/profiling.py::backward_span`).  Without a profiler it records
nothing.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn
from torch.profiler import record_function

from lav_tpu_torch.nn.layers import BatchNorm


def bn_state(module: nn.Module) -> dict:
    """{qualified name: (mean, var)} of every BatchNorm under `module`
    holding an update not yet merged."""
    return {name: m.new_stats for name, m in module.named_modules()
            if isinstance(m, BatchNorm) and m.new_stats is not None}


def merge_bn_state(module: nn.Module) -> nn.Module:
    """Write every recorded update under `module` into its running
    statistics and clear it."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm) and m.new_stats is not None:
                m.mean.copy_(m.new_stats[0])
                m.var.copy_(m.new_stats[1])
                m.new_stats = None
    return module


def checkpoint(fn, *args, module: nn.Module, span: str):
    """fn(*args) under `torch.utils.checkpoint.checkpoint` (non-reentrant):
    its activations are not kept but recomputed in the backward pass, as
    lav_tpu's `jax.checkpoint` does.  The recompute runs fn's train-mode
    BatchNorms again, after the rest of the forward: the crop ResNet's
    call on the other cars' crops would overwrite the ego's update, which
    came later in the forward.  lav_tpu's BN state is an output of its
    forward, which a recompute does not change; so the updates recorded
    under `module` before a recompute are put back after it, and every
    BatchNorm keeps its forward's update.  The recompute runs under the
    `record_function` label `span`."""
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:    # the forward
            return fn(*a)
        kept = [(m, m.new_stats) for m in module.modules()
                if isinstance(m, BatchNorm)]
        try:
            with record_function(span):
                return fn(*a)
        finally:
            for m, stats in kept:
                m.new_stats = stats

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
