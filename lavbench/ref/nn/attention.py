"""Single-learned-query multi-head attention pooling of the v2 brake net
(counterpart of `lav_tpu/nn/attention.py`): one learned query attends over
the flattened feature map, with 1-D sinusoidal positions added to keys.
As in lav_tpu, the f32 query and positions promote a bf16 input: keys,
scores, softmax and output are f32."""

from __future__ import annotations

import math

import torch
from torch import nn

from lavbench.ref.nn import layers as L


def positional_encoding_1d(d_model: int, length: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class AttentionPool(nn.Module):
    """x (B, H, W, D) NHWC -> pooled (B, D)."""

    def __init__(self, dim: int, num_heads: int = 8, gen=None):
        super().__init__()
        assert dim % num_heads == 0
        self.num_heads = num_heads
        self.q = nn.Parameter(
            gen.normal((1, num_heads, 1, dim // num_heads))
            if hasattr(gen, "normal") else
            torch.randn((1, num_heads, 1, dim // num_heads), generator=gen))
        self.linear_kv = L.Linear(dim, dim * 2, gen=gen)

    def forward(self, x):
        B, H, W, D = x.shape
        nh = self.num_heads
        dh = D // nh
        n = H * W
        kv = self.linear_kv(x.reshape(B, n, D))
        k, v = kv.chunk(2, dim=-1)
        k = k.reshape(B, n, nh, dh).transpose(1, 2)
        v = v.reshape(B, n, nh, dh).transpose(1, 2)
        k = k.float() + positional_encoding_1d(dh, n, x.device)
        q = self.q.float().expand(B, nh, 1, dh)
        dots = torch.matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
        attn = torch.softmax(dots, dim=-1)
        out = torch.matmul(attn, v.float())
        return out.transpose(1, 2).reshape(B, D)
