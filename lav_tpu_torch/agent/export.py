"""Ahead-of-time export of the agent tick (counterpart of
`lav_tpu/agent/export.py`).

lav_tpu serialises its jitted step with `jax.export`; the port does it
with `torch.export`: the tick is traced once, with the weights baked into
the program, and saved with `torch.export.save`, so a serving process runs
it without the model code.

    from lav_tpu_torch.agent.export import export_agent_step, load_agent_step
    blob = export_agent_step(cfg, models)            # bytes
    step = load_agent_step(blob)                     # (state, obs) -> ...

The program calls the port's kernels as the custom ops of the
`lav_tpu_torch` namespace (`utils/native.py`), and its float transposed
convs as one too (`nn/layers.py::conv_transpose2d`, which scopes cuDNN's
deterministic flag to them), and the tick's pytrees
(`AgentState`, `Control`, `EKFState`) are registered under stable names;
loading imports the modules that register both, as lav_tpu registers its
pytrees in `load_agent_step`.  The program runs on the device it was
exported on.
"""

from __future__ import annotations

import copy
import io
from typing import Callable

import torch
from torch import nn

from lav_tpu_torch.agent.agent import AgentState, Control, build_agent
from lav_tpu_torch.agent.ekf import EKFState
from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.utils import native
from lav_tpu_torch.utils.device import resolve_device

_REGISTERED = False


def register_pytrees() -> None:
    """Give the tick's named tuples their serialized names, once."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.utils import _pytree

    for cls in (AgentState, Control, EKFState):
        _pytree._register_namedtuple(
            cls, serialized_type_name=f"lav_tpu_torch.{cls.__name__}")
    # the saved example inputs hold them: let torch.load's weights-only
    # unpickler rebuild them
    torch.serialization.add_safe_globals([AgentState, Control, EKFState])
    _REGISTERED = True


def example_obs(cfg: LAVConfig, state: AgentState, rgb_hw, tel_hw,
                device) -> dict:
    """Zero observations of the shapes the tick takes (`build_agent`)."""
    E, P = state.prev_lidar.shape[:2]

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(lidar=z(E, P, 4), lidar_valid=z(E, P, dtype=torch.bool),
                rgbs=z(E, 3, *rgb_hw, 3), tel_rgb=z(E, *tel_hw, 3),
                gps=z(E, 2), compass=z(E), speed=z(E),
                cmd=z(E, dtype=torch.int32), target=z(E, 2))


class _Tick(nn.Module):
    """The tick with the models as submodules, so that export lifts their
    weights into the program."""

    def __init__(self, models, step):
        super().__init__()
        self.models = models
        self.step = step

    def forward(self, state, obs):
        return self.step(self.models, state, obs)


def export_agent_step(cfg: LAVConfig, models, *, max_points: int = 8192,
                      rgb_hw=(288, 256), tel_hw=(192, 480),
                      compute_dtype=None, quant_int8: bool = False,
                      num_ego: int = 1, device=None) -> bytes:
    """Serialise the tick of `num_ego` egos with `models` (an
    `AgentModels`) baked in, on `device` (default `cuda`; raises without a
    card unless `device='cpu'`).

    compute_dtype / quant_int8 export lav_tpu's serving configuration
    (bf16 activations, the lidar model and the planner's crop ResNet in
    int8): a copy of the models is quantized here and not calibrated, so
    each int8 conv quantizes its input with a dynamic per-tensor scale, as
    lav_tpu's exported step does.  `models` is left as it was."""
    from lav_tpu_torch.nn import quant as Q

    dev = resolve_device(device)
    register_pytrees()
    models = copy.deepcopy(models).to(dev).eval()
    if quant_int8:
        Q.quantize_tree(models.lidar_model)
        Q.quantize_tree(models.uniplanner)
    init_state, step = build_agent(cfg, num_ego=num_ego,
                                   max_points=max_points, rgb_hw=rgb_hw,
                                   compute_dtype=compute_dtype, device=dev)
    state = init_state()
    obs = example_obs(cfg, state, rgb_hw, tel_hw, dev)
    with torch.no_grad(), native.exporting():
        program = torch.export.export(_Tick(models, step), (state, obs),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_agent_step(blob: bytes) -> Callable:
    """The exported tick as a callable (state, obs) -> (Control,
    AgentState, aux).  Its float transposed convs are the custom op of
    `layers.conv_transpose2d`, so they, and nothing else, run under
    cuDNN's deterministic flag, as in the eager tick."""
    # registers the custom ops that the program calls
    from lav_tpu_torch.core import warp  # noqa: F401
    from lav_tpu_torch.nn import layers, quant  # noqa: F401
    from lav_tpu_torch.ops import pillar  # noqa: F401

    register_pytrees()
    program = torch.export.load(io.BytesIO(blob))
    run = program.module()

    def step(state, obs):
        with torch.no_grad():
            return run(state, obs)
    return step
