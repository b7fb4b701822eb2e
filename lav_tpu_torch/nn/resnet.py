"""ResNet returning the layer4 feature map (counterpart of
`lav_tpu/nn/resnet.py`): the backbone of the planners and the brake net.

Submodule names follow lav_tpu's params (`conv1`, `bn1`, `layer{s}_{b}`
blocks with `conv1/bn1/conv2/bn2` and `down_conv/down_bn`).  lav_tpu's
space-to-depth rewrite of the entry conv is a TPU layout tactic computing
the same products; here the entry conv is the plain 7x7 stride-2 conv.
Under int8 (`nn/quant.py`) an int8 `conv1` consumes int8 input (the
planner's q8 crops) as it is and emits bf16; every later layer runs in
bf16.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from lav_tpu_torch.nn import layers as L


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1, gen=None):
        super().__init__()
        self.conv1 = L.Conv2d(cin, cout, 3, stride, 1, bias=False, gen=gen)
        self.bn1 = L.BatchNorm(cout)
        self.conv2 = L.Conv2d(cout, cout, 3, 1, 1, bias=False, gen=gen)
        self.bn2 = L.BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.down_conv = L.Conv2d(cin, cout, 1, stride, 0, bias=False,
                                      gen=gen)
            self.down_bn = L.BatchNorm(cout)
        else:
            self.down_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.down_conv is None else self.down_bn(
            self.down_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """x (B, C, H, W) -> layer4 features (B, 512, H/32, W/32)."""

    def __init__(self, layers_cfg: Sequence[int] = (2, 2, 2, 2),
                 num_channels: int = 3, width: int = 64, gen=None):
        super().__init__()
        self.conv1 = L.Conv2d(num_channels, width, 7, 2, 3, bias=False,
                              gen=gen)
        self.bn1 = L.BatchNorm(width)
        self.block_names = []
        cin = width
        for stage, blocks in enumerate(layers_cfg):
            cout = width * (2 ** stage)
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                setattr(self, name, BasicBlock(cin, cout, stride, gen=gen))
                self.block_names.append(name)
                cin = cout

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.max_pool2d(out, 3, 2, 1)
        for name in self.block_names:
            out = getattr(self, name)(out)
        return out


def resnet18(num_channels: int = 3, gen=None) -> ResNet:
    return ResNet((2, 2, 2, 2), num_channels, gen=gen)


def resnet_apply(net: ResNet, x):
    """lav_tpu's `resnet_apply` in NHWC: (B, H, W, C) -> (B, H/32, W/32, 512)."""
    return L.nchw_to_nhwc(net(L.nhwc_to_nchw(x)))
