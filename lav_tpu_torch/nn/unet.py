"""Classic UNet (counterpart of `lav_tpu/nn/unet.py`): the reference
imports it but never builds it (team_code_v2/models/unet.py:6-36); lav_tpu
keeps it as a usable segmentation backbone, and so does the port.

Modules are named after lav_tpu's params (`down_i`, `up_i` with its
`upconv`, `out`), so `utils/weights.py::load_jax_params` fills them from
a `unet_init` tree.  Under lav_tpu's all-stacks int8 scope the `upconv`
subtrees stay float (`nn/quant.py::_SKIP_KEYS`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lav_tpu_torch.nn import layers as L


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) twice."""

    def __init__(self, cin: int, cout: int, gen=None):
        super().__init__()
        self.conv1 = L.Conv2d(cin, cout, 3, padding=1, gen=gen)
        self.bn1 = L.BatchNorm(cout)
        self.conv2 = L.Conv2d(cout, cout, 3, padding=1, gen=gen)
        self.bn2 = L.BatchNorm(cout)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Up(DoubleConv):
    """A 2x2 stride-2 transposed conv, the skip concatenated before it,
    then the double conv."""

    def __init__(self, cin: int, cout: int, gen=None):
        super().__init__(2 * cout, cout, gen=gen)
        self.upconv = L.ConvTranspose2d(cin, cout, 2, 2, gen=gen)

    def forward(self, x, skip):
        return super().forward(torch.cat([skip, self.upconv(x)], dim=1))


class UNet(nn.Module):
    """forward(x (B, H, W, cin) NHWC, H and W multiples of 2^(levels-1))
    -> logits (B, H, W, num_classes); BatchNorm on batch statistics in
    train mode (`.train()`), on its running statistics otherwise."""

    def __init__(self, cin: int, num_classes: int,
                 widths=(64, 128, 256, 512), gen=None):
        super().__init__()
        self.levels = len(widths)
        c = cin
        for i, w in enumerate(widths):
            setattr(self, f"down_{i}", DoubleConv(c, w, gen=gen))
            c = w
        for i, w in enumerate(reversed(widths[:-1])):
            setattr(self, f"up_{i}", Up(c, w, gen=gen))
            c = w
        self.out = L.Conv2d(c, num_classes, 1, gen=gen)
        self.eval()   # inference unless a caller asks for train mode

    def forward(self, x):
        x = L.nhwc_to_nchw(x)
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"down_{i}")(x)
            if i < self.levels - 1:
                skips.append(x)
                x = F.max_pool2d(x, 2, 2)
        for i in range(self.levels - 1):
            x = getattr(self, f"up_{i}")(x, skips.pop())
        return L.nchw_to_nhwc(self.out(x))
