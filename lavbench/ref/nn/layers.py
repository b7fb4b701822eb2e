"""Layers with torch semantics, as nn.Modules named after lav_tpu's params.

Counterpart of `lav_tpu/nn/layers.py`.  Each module's parameter names are
the keys of the matching lav_tpu params dict (`w`, `b`; BatchNorm `scale`,
`bias`, `mean`, `var`; GRU `w_ih`, `w_hh`, `b_ih`, `b_hh`), stored in
PyTorch's own layout (OIHW convs, (in, out, kh, kw) transposed convs,
(3H, I) GRU weights); `utils/weights.py` converts lav_tpu's HWIO / (I, 3H)
arrays into them.

Convolution modules take NCHW tensors (the models feed them channels_last
memory); the models' public functions keep lav_tpu's NHWC layout.
BatchNorm applies its running statistics in eval mode, the mode a new
module is in; in train mode (`.train()`) it normalises with the batch's
statistics and records the updated running statistics without applying
them (`utils/tree.py::merge_bn_state` applies them after the optimizer
step).

Initialisers follow torch's defaults (kaiming_uniform(a=sqrt(5)) weights,
uniform(+-1/sqrt(fan_in)) biases, uniform(+-1/sqrt(H)) GRU) and draw from
an explicit `torch.Generator`.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavbench.ref.nn import quant


def _uniform(gen, shape, bound: float) -> torch.Tensor:
    """uniform(+-bound) of `shape` from `gen`: a torch.Generator, or a
    `lavbench.weights` draw that hands out slices of one large draw."""
    if hasattr(gen, "uniform"):
        return gen.uniform(shape, bound)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _kaiming_bound(fan_in: int, a: float = math.sqrt(5.0)) -> float:
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return gain * math.sqrt(3.0 / fan_in)


def _weight(gen, shape, fan_in: int) -> torch.Tensor:
    """A weight of `shape` over `fan_in` inputs: kaiming-uniform(a=sqrt(5))
    from a torch.Generator; from a `lavbench.weights` draw, its `weight`."""
    if hasattr(gen, "weight"):
        return gen.weight(shape, fan_in)
    return _uniform(gen, shape, _kaiming_bound(fan_in))


def _bias_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms inside the block,
    its flag put back after it.  On the card cuDNN's default algorithm for
    a float transposed conv (the ERFNet upsamplers' and the lidar
    backbone's and BEV head's, f32) adds its terms in an order that
    changes from run to run, so the agent tick would not repeat itself;
    `ConvTranspose2d` runs inside this scope, and nothing sets the flag
    for the rest of the process.  The flag is the process's own while the
    block runs."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], stride: List[int],
                     padding: List[int],
                     output_padding: List[int]) -> torch.Tensor:
    """F.conv_transpose2d under `cudnn_deterministic`."""
    with cudnn_deterministic():
        return F.conv_transpose2d(x, w, b, stride, padding, output_padding)


class Linear(nn.Module):
    """y = x @ w.T + b with w (out, in); the bias is added to the rounded
    product, as lav_tpu's `x @ w + b` does (it matters in bf16)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, gen=None):
        super().__init__()
        self.w = nn.Parameter(_weight(gen, (cout, cin), cin))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(cin)))
                  if bias else None)

    def forward(self, x):
        y = F.linear(x, self.w.to(x.dtype))
        return y if self.b is None else y + self.b.to(x.dtype)


class Conv2d(nn.Module):
    """torch.nn.Conv2d semantics with symmetric integer/tuple zero padding.

    `quantize_` switches it to lav_tpu's int8 form (`nn/quant.py`): the
    float `w` goes, buffers `w_int8` (O, KH, KW, I), `w_scale` (O,) and,
    once calibrated, `x_scale` () take its place, and forward runs
    `quant.conv2d_int8` (an int8 input is consumed as it is)."""

    def __init__(self, cin: int, cout: int, ksize, stride=1, padding=0,
                 dilation=1, bias: bool = True, gen=None):
        super().__init__()
        kh, kw = _pair(ksize)
        fan_in = cin * kh * kw
        self.cin, self.cout, self.ksize = cin, cout, (kh, kw)
        self.w = nn.Parameter(
            _weight(gen, (cout, cin, kh, kw), fan_in))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(fan_in)))
                  if bias else None)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation = _pair(dilation)
        self.register_buffer("w_int8", None)
        self.register_buffer("w_scale", None)
        self.register_buffer("x_scale", None)
        self._s2d = None

    def quantize_(self, w_int8=None, w_scale=None):
        """Switch to int8 weights, quantized from `w` unless given."""
        if w_int8 is None:
            w_int8, w_scale = quant.quantize_conv(self.w)
        _set_int8(self, w_int8, w_scale)
        return self

    def s2d_weight(self):
        """`quant.s2d_weight` of w_int8, derived once and kept while
        w_int8 stays the same tensor with the same contents."""
        w = self.w_int8
        key = (w.device, w.data_ptr(), w._version)
        if self._s2d is None or self._s2d[0] != key:
            self._s2d = (key, quant.s2d_weight(w))
        return self._s2d[1]

    def forward(self, x, x_scale=None):
        if self.w_int8 is not None:
            y = quant.conv2d_int8(self, nchw_to_nhwc(x), x_scale=x_scale)
            return nhwc_to_nchw(y)
        b = None if self.b is None else self.b.to(x.dtype)
        return F.conv2d(x, self.w.to(x.dtype), b, self.stride, self.padding,
                        self.dilation)


def _set_int8(conv, w_int8, w_scale):
    """Give `conv` its int8 weight (O, KH, KW, I) and scales in place of
    the float `w`."""
    kh, kw = conv.ksize
    if tuple(w_int8.shape) != (conv.cout, kh, kw, conv.cin) or \
            w_int8.dtype != torch.int8:
        raise ValueError(f"int8 weight {w_int8.dtype} {tuple(w_int8.shape)} "
                         f"for a conv {conv.cin}->{conv.cout} {kh}x{kw}")
    conv.w = None
    conv.w_int8 = w_int8
    conv.w_scale = w_scale.float()


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d; w is (in, out, kh, kw).  lav_tpu stores
    the equivalent input-dilated conv's kernel, flipped at apply time, as
    HWIO (kh, kw, in, out) — the same numbers in another order.

    `quantize_` switches it to lav_tpu's int8 form (`LAV_INT8_UPCONV=1`,
    `quant.conv_transpose2d_int8`): buffers `w_int8`, the flipped
    equivalent conv's kernel (O, KH, KW, I) with per-output-channel scales
    `w_scale` (O,), and `x_scale` once calibrated.  The float form runs
    under `cudnn_deterministic` (`conv_transpose2d`)."""

    def __init__(self, cin: int, cout: int, ksize, stride=1, padding=0,
                 output_padding=0, bias: bool = True, gen=None):
        super().__init__()
        kh, kw = _pair(ksize)
        fan_in = cout * kh * kw  # torch's transposed fan
        self.cin, self.cout, self.ksize = cin, cout, (kh, kw)
        self.w = nn.Parameter(
            _weight(gen, (cin, cout, kh, kw), fan_in))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(fan_in)))
                  if bias else None)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.output_padding = _pair(output_padding)
        self.register_buffer("w_int8", None)
        self.register_buffer("w_scale", None)
        self.register_buffer("x_scale", None)

    def quantize_(self, w_int8=None, w_scale=None):
        """Switch to int8 weights, quantized from `w` (as the flipped
        equivalent conv's kernel) unless given."""
        if w_int8 is None:
            w_conv = self.w.detach().transpose(0, 1).flip(2, 3)
            w_int8, w_scale = quant.quantize_conv(w_conv)
        _set_int8(self, w_int8, w_scale)
        return self

    def forward(self, x):
        if self.w_int8 is not None:
            y = quant.conv_transpose2d_int8(self, nchw_to_nhwc(x))
            return nhwc_to_nchw(y)
        b = None if self.b is None else self.b.to(x.dtype)
        return conv_transpose2d(x, self.w.to(x.dtype), b, list(self.stride),
                    list(self.padding), list(self.output_padding))


class BatchNorm(nn.Module):
    """BatchNorm over channel axis `dim` (1 for NCHW, -1 for (..., C) point
    features).

    Eval mode: running stats and affine folded into one per-channel
    scale/shift in f32, applied in the input dtype.  Train mode
    (lav_tpu `nn/layers.py::batchnorm`, train=True): statistics in f32
    over every axis but `dim`, restricted to `mask` (broadcastable to x
    without its channel axis) when given; normalised with the biased
    variance; y = (x - mean) * rsqrt(var + eps) * scale + bias, cast to
    the input dtype; one process holds the whole batch.  The updated running statistics,
    (1 - momentum) * old + momentum * batch with the unbiased variance,
    are kept in `new_stats` and not applied: a module called twice before
    `merge_bn_state` keeps only its last call's update, computed from the
    old statistics, as lav_tpu's state tree does
    (`utils/tree.py::merge_bn_state`)."""

    def __init__(self, c: int, eps: float = 1e-5, dim: int = 1,
                 momentum: float = 0.1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps, self.dim, self.momentum = eps, dim, momentum
        self.new_stats = None
        self.eval()   # inference unless a caller asks for train mode

    def _channel_shape(self, x):
        if self.dim == -1 or self.dim == x.ndim - 1:
            return (-1,)
        shape = [1] * x.ndim
        shape[self.dim] = -1
        return tuple(shape)

    def forward(self, x, mask=None):
        shape = self._channel_shape(x)
        if self.training:
            return self._train(x, mask, shape)
        inv = torch.rsqrt(self.var.float() + self.eps)
        scale = (self.scale.float() * inv).to(x.dtype)
        shift = (self.bias.float()
                 - self.mean.float() * self.scale.float() * inv).to(x.dtype)
        return x * scale.reshape(shape) + shift.reshape(shape)

    def _train(self, x, mask, shape):
        dim = self.dim % x.ndim
        axes = tuple(a for a in range(x.ndim) if a != dim)
        xs = x.float()
        if mask is None:
            mean = xs.mean(dim=axes)
            var = ((xs - mean.reshape(shape)) ** 2).mean(dim=axes)
            n = float(math.prod(x.shape[a] for a in axes))
        else:
            m = mask.float().unsqueeze(dim)
            n = torch.clamp(m.sum(), min=1.0)
            mean = (xs * m).sum(dim=axes) / n
            var = (((xs - mean.reshape(shape)) ** 2) * m).sum(dim=axes) / n
        y = (xs - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(
            shape)
        with torch.no_grad():
            unbiased = var * n / (torch.clamp(n - 1.0, min=1.0)
                                  if mask is not None else max(n - 1.0, 1.0))
            mom = self.momentum
            self.new_stats = ((1 - mom) * self.mean + mom * mean,
                              (1 - mom) * self.var + mom * unbiased)
        y = y * self.scale.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


def _gru_cell(xi_t, h, w_hh, b_hh):
    """One torch.nn.GRU step; xi_t = W_ih x_t + b_ih precomputed.  Gates
    ordered (reset, update, new)."""
    hh = torch.matmul(h, w_hh.transpose(-1, -2)) + b_hh
    ir, iz, inn = xi_t.chunk(3, dim=-1)
    hr, hz, hn = hh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


class GRU(nn.Module):
    """Single-layer batch-first torch.nn.GRU: x (B, T, I), h0 (B, H) ->
    (outputs (B, T, H), h_T)."""

    def __init__(self, input_size: int, hidden_size: int, gen=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        H = hidden_size
        self.w_ih = nn.Parameter(_uniform(gen, (3 * H, input_size), bound))
        self.w_hh = nn.Parameter(_uniform(gen, (3 * H, H), bound))
        self.b_ih = nn.Parameter(_uniform(gen, (3 * H,), bound))
        self.b_hh = nn.Parameter(_uniform(gen, (3 * H,), bound))

    def forward(self, x, h0=None):
        B, T, _ = x.shape
        H = self.w_hh.shape[1]
        h = x.new_zeros((B, H)) if h0 is None else h0
        xi = F.linear(x, self.w_ih.to(x.dtype), self.b_ih.to(x.dtype))
        w_hh, b_hh = self.w_hh.to(x.dtype), self.b_hh.to(x.dtype)
        outs = []
        for t in range(T):
            h = _gru_cell(xi[:, t], h, w_hh, b_hh)
            outs.append(h)
        return torch.stack(outs, dim=1), h


class GRUBank(nn.Module):
    """`n` independent GRUs with stacked weights (lav_tpu's vmapped bank):
    x (B, T, I) shared by all -> outputs (n, B, T, H)."""

    def __init__(self, n: int, input_size: int, hidden_size: int, gen=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden_size)
        H = hidden_size
        self.w_ih = nn.Parameter(_uniform(gen, (n, 3 * H, input_size), bound))
        self.w_hh = nn.Parameter(_uniform(gen, (n, 3 * H, H), bound))
        self.b_ih = nn.Parameter(_uniform(gen, (n, 3 * H), bound))
        self.b_hh = nn.Parameter(_uniform(gen, (n, 3 * H), bound))

    def forward(self, x):
        B, T, _ = x.shape
        n, H3, H = self.w_hh.shape
        xi = (torch.einsum("bti,ngi->nbtg", x, self.w_ih.to(x.dtype))
              + self.b_ih.to(x.dtype)[:, None, None])
        w_hh = self.w_hh.to(x.dtype)
        b_hh = self.b_hh.to(x.dtype)[:, None]
        h = x.new_zeros((n, B, H))
        outs = []
        for t in range(T):
            h = _gru_cell(xi[:, :, t], h, w_hh, b_hh)
            outs.append(h)
        return torch.stack(outs, dim=2)


class LinearBank(nn.Module):
    """`n` stacked linears: x (n, ..., I) -> (n, ..., O)."""

    def __init__(self, n: int, cin: int, cout: int, gen=None):
        super().__init__()
        self.w = nn.Parameter(_uniform(gen, (n, cout, cin),
                                       _kaiming_bound(cin)))
        self.b = nn.Parameter(_uniform(gen, (n, cout), _bias_bound(cin)))

    def forward(self, x):
        n = x.shape[0]
        flat = x.reshape(n, -1, x.shape[-1])
        y = torch.baddbmm(self.b.to(x.dtype)[:, None], flat,
                          self.w.to(x.dtype).transpose(1, 2))
        return y.reshape(*x.shape[:-1], -1)


def max_pool2d(x, ksize: int, stride: int, padding: int = 0):
    """torch MaxPool2d on NHWC input; padding never wins (-inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), ksize, stride, padding)
    return y.permute(0, 2, 3, 1)


def dropout(x, mask, rate: float):
    """lav_tpu's train-mode dropout with its mask given: where(mask, x /
    keep, 0), keep = 1 - rate; `mask` a bool tensor of x's shape, True
    where x is kept."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def dropout_mask(gen, shape, rate: float, device=None):
    """A dropout mask of `shape` drawn from the torch.Generator `gen`,
    which lives on `device` (the activation's): True with probability 1 -
    rate, as jax.random.bernoulli(key, 1 - rate, shape) draws it."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)


def interpolate_nearest(x, scale: int):
    """F.interpolate(scale_factor=s) nearest mode on NHWC input."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def nhwc_to_nchw(x):
    """NHWC tensor -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)
