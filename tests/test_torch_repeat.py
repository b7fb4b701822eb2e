"""The repair of ROADMAP C10 (the eager tick on the card differed from
itself): cuDNN's deterministic flag is scoped to the float transposed
convs (`nn/layers.py::cudnn_deterministic`, inside `ConvTranspose2d`
through `layers.conv_transpose2d`, and in an exported program through
its custom op), and set for nothing else.

* the scope sets the flag inside and puts back what it found, also on an
  exception;
* in the agent tick (eager, and the exported program as
  `load_agent_step` runs it) every transposed conv runs with the flag
  set and every plain conv without it;
* the exported program calls the transposed convs as the custom op;
* setting up the agent (its int8 calibration runs ticks) and stepping it
  leave PyTorch's deterministic algorithms, cuDNN's flag and
  CUBLAS_WORKSPACE_CONFIG as they were;
* on the CPU the scoped conv and its custom op equal
  `F.conv_transpose2d` bit for bit, at the tick's transposed convs'
  kernels, strides and paddings.
"""

import os

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from lav_tpu_torch.agent import export as TX
from lav_tpu_torch.agent.setup import v2_agent_setup
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.utils import native

HW = (32, 32)
P = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flags():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


CONV_T_OP = torch.ops.lav_tpu_torch.conv_transpose2d_deterministic.default


class ConvSpy(TorchDispatchMode):
    """Records (transposed, cudnn.deterministic) at every convolution,
    those inside the transposed conv's custom op too, and counts the
    op's calls."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is CONV_T_OP:
            self.ops += 1
            with self:      # the op's own implementation, watched
                return L.conv_transpose2d(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            self.calls.append((bool(args[6]),
                               torch.backends.cudnn.deterministic))
        elif func is torch.ops.aten.conv_transpose2d.input:
            # not decomposed to aten.convolution inside the op
            self.calls.append((True, torch.backends.cudnn.deterministic))
        return func(*args, **(kwargs or {}))


def test_scope_sets_and_restores_the_flag():
    before = torch.backends.cudnn.deterministic
    assert before is False
    with L.cudnn_deterministic():
        assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.deterministic is False
    with pytest.raises(ValueError):
        with L.cudnn_deterministic():
            raise ValueError
    assert torch.backends.cudnn.deterministic is False
    torch.backends.cudnn.deterministic = True
    try:
        with L.cudnn_deterministic():
            pass
        assert torch.backends.cudnn.deterministic is True
    finally:
        torch.backends.cudnn.deterministic = before


def _setup(**kw):
    import lav_tpu_torch.agent.setup as S

    cfg = tiny_config(num_frame_stack=2)
    saved = S.v2_config, S.TEL_HW
    S.v2_config, S.TEL_HW = (lambda: cfg), HW
    try:
        return v2_agent_setup(max_points=P, num_ego=2, img_hw=HW,
                              device="cpu", **kw)
    finally:
        S.v2_config, S.TEL_HW = saved


@pytest.mark.parametrize("kw", [dict(use_pallas=True),
                                dict(quant="mxu",
                                     compute_dtype=torch.bfloat16)],
                         ids=["f32", "production"])
def test_tick_scopes_only_the_transposed_convs(kw):
    before = _flags()
    step, models, state, obs, _ = _setup(**kw)
    assert _flags() == before
    ups = [m for n, m in models.named_modules()
           if isinstance(m, L.ConvTranspose2d) and m.w_int8 is None
           and not n.startswith("bra_model.seg_head")]
    spy = ConvSpy()
    with spy:
        for _ in range(2):
            _, state, _ = step(models, state, obs)
    transposed = [flag for t, flag in spy.calls if t]
    plain = [flag for t, flag in spy.calls if not t]
    assert len(transposed) == 2 * len(ups) > 0
    assert all(transposed) and plain and not any(plain)
    assert _flags() == before


def test_loaded_tick_scopes_the_transposed_convs():
    step, models, state, obs, cfg = _setup()
    blob = TX.export_agent_step(cfg, models, max_points=P, rgb_hw=HW,
                                tel_hw=HW, num_ego=2, device="cpu")
    loaded = TX.load_agent_step(blob)
    before = _flags()
    spy = ConvSpy()
    with spy:
        ctrl, _, _ = loaded(state, obs)
    ups = [m for n, m in models.named_modules()
           if isinstance(m, L.ConvTranspose2d) and m.w_int8 is None
           and not n.startswith("bra_model.seg_head")]
    transposed = [flag for t, flag in spy.calls if t]
    plain = [flag for t, flag in spy.calls if not t]
    assert spy.ops == len(transposed) == len(ups) > 0
    assert all(transposed) and plain and not any(plain)
    assert _flags() == before
    want, _, _ = step(models, state, obs)
    for a, b in zip(ctrl, want):
        assert torch.equal(a, b)


def test_exported_graph_calls_the_op():
    g = torch.Generator().manual_seed(3)
    conv = L.ConvTranspose2d(8, 4, 3, 2, 1, 1, gen=g)
    x = torch.randn((1, 8, 5, 6), generator=g)
    with torch.no_grad(), native.exporting():
        program = torch.export.export(conv, (x,), strict=False)
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    assert CONV_T_OP in targets
    assert torch.ops.aten.convolution.default not in targets
    with torch.no_grad():
        assert torch.equal(program.module()(x), conv(x))


SHAPES = [(128, 64, 3, 2, 1, 1), (16, 5, 2, 2, 0, 0), (64, 128, 1, 1, 0, 0),
          (128, 128, 4, 2, 1, 0), (128, 128, 4, 4, 1, 2), (64, 3, 3, 2, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,s,p,op", SHAPES)
def test_scoped_conv_equals_the_plain_op(cin, cout, k, s, p, op, dtype):
    """At the tick's transposed convs' kernels, strides and paddings."""
    g = torch.Generator().manual_seed(k * 10 + s)
    conv = L.ConvTranspose2d(cin, cout, k, s, p, op, gen=g)
    x = torch.randn((2, cin, 7, 5), generator=g).to(dtype)
    w, b = conv.w.detach().to(dtype), conv.b.detach().to(dtype)
    want = F.conv_transpose2d(x, w, b, s, p, op)
    args = (x, w, b, [s, s], [p, p], [op, op])
    with torch.no_grad():
        assert torch.equal(conv(x), want)
        assert torch.equal(L.conv_transpose2d(*args), want)
        assert torch.equal(L._CONV_T_OP(*args), want)
