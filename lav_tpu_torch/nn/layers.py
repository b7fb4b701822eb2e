"""Layers with torch semantics, as nn.Modules named after lav_tpu's params.

Counterpart of `lav_tpu/nn/layers.py`.  Each module's parameter names are
the keys of the matching lav_tpu params dict (`w`, `b`; BatchNorm `scale`,
`bias`, `mean`, `var`; GRU `w_ih`, `w_hh`, `b_ih`, `b_hh`), stored in
PyTorch's own layout (OIHW convs, (in, out, kh, kw) transposed convs,
(3H, I) GRU weights); `utils/weights.py` converts lav_tpu's HWIO / (I, 3H)
arrays into them.

Convolution modules take NCHW tensors (the models feed them channels_last
memory); the models' public functions keep lav_tpu's NHWC layout.  Every
module is inference-only: BatchNorm applies its running statistics.

Initialisers follow torch's defaults (kaiming_uniform(a=sqrt(5)) weights,
uniform(+-1/sqrt(fan_in)) biases, uniform(+-1/sqrt(H)) GRU) and draw from
an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _uniform(gen, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _kaiming_bound(fan_in: int, a: float = math.sqrt(5.0)) -> float:
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return gain * math.sqrt(3.0 / fan_in)


def _bias_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Linear(nn.Module):
    """y = x @ w.T + b with w (out, in)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, gen=None):
        super().__init__()
        self.w = nn.Parameter(_uniform(gen, (cout, cin), _kaiming_bound(cin)))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(cin)))
                  if bias else None)

    def forward(self, x):
        b = None if self.b is None else self.b.to(x.dtype)
        return F.linear(x, self.w.to(x.dtype), b)


class Conv2d(nn.Module):
    """torch.nn.Conv2d semantics with symmetric integer/tuple zero padding."""

    def __init__(self, cin: int, cout: int, ksize, stride=1, padding=0,
                 dilation=1, bias: bool = True, gen=None):
        super().__init__()
        kh, kw = _pair(ksize)
        fan_in = cin * kh * kw
        self.w = nn.Parameter(
            _uniform(gen, (cout, cin, kh, kw), _kaiming_bound(fan_in)))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(fan_in)))
                  if bias else None)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation = _pair(dilation)

    def forward(self, x):
        b = None if self.b is None else self.b.to(x.dtype)
        return F.conv2d(x, self.w.to(x.dtype), b, self.stride, self.padding,
                        self.dilation)


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d; w is (in, out, kh, kw).  lav_tpu stores
    the equivalent input-dilated conv's kernel, flipped at apply time, as
    HWIO (kh, kw, in, out) — the same numbers in another order."""

    def __init__(self, cin: int, cout: int, ksize, stride=1, padding=0,
                 output_padding=0, bias: bool = True, gen=None):
        super().__init__()
        kh, kw = _pair(ksize)
        fan_in = cout * kh * kw  # torch's transposed fan
        self.w = nn.Parameter(
            _uniform(gen, (cin, cout, kh, kw), _kaiming_bound(fan_in)))
        self.b = (nn.Parameter(_uniform(gen, (cout,), _bias_bound(fan_in)))
                  if bias else None)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.output_padding = _pair(output_padding)

    def forward(self, x):
        b = None if self.b is None else self.b.to(x.dtype)
        return F.conv_transpose2d(x, self.w.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over channel axis `dim` (1 for NCHW, -1 for
    (..., C) point features): running stats and affine folded into one
    per-channel scale/shift in f32, applied in the input dtype."""

    def __init__(self, c: int, eps: float = 1e-5, dim: int = 1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.eps, self.dim = eps, dim

    def forward(self, x):
        inv = torch.rsqrt(self.var.float() + self.eps)
        scale = (self.scale.float() * inv).to(x.dtype)
        shift = (self.bias.float()
                 - self.mean.float() * self.scale.float() * inv).to(x.dtype)
        if self.dim != -1 and self.dim != x.ndim - 1:
            shape = [1] * x.ndim
            shape[self.dim] = -1
            scale, shift = scale.reshape(shape), shift.reshape(shape)
        return x * scale + shift


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


def interpolate_nearest(x, scale: int):
    """F.interpolate(scale_factor=s) nearest mode on NHWC input."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def nhwc_to_nchw(x):
    """NHWC tensor -> NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)
