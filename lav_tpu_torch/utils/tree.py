"""BatchNorm running statistics of a train step (counterpart of
`lav_tpu/utils/tree.py`).

lav_tpu's apply functions return a state tree of updated BN statistics,
and the train step writes it into the params once, after the optimizer
step.  Here each train-mode `BatchNorm` keeps its update in `new_stats`;
`bn_state` reads them and `merge_bn_state` writes them into the running
statistics.  A module called twice in one step keeps its last call's
update, each computed from the statistics of before the step.
"""

from __future__ import annotations

import torch
from torch import nn

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
