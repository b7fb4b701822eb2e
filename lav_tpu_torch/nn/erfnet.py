"""ERFNet encoder-decoder for camera segmentation (counterpart of
`lav_tpu/nn/erfnet.py`): downsamplers (conv || maxpool concat),
factorised non-bottleneck-1d residual blocks with dilation, transposed-conv
upsamplers.  BatchNorm eps 1e-3.  Inference only (dropout is off)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lav_tpu_torch.nn import layers as L

_BN_EPS = 1e-3


class Downsampler(nn.Module):
    def __init__(self, cin: int, cout: int, gen=None):
        super().__init__()
        self.conv = L.Conv2d(cin, cout - cin, 3, 2, 1, bias=True, gen=gen)
        self.bn = L.BatchNorm(cout, eps=_BN_EPS)

    def forward(self, x):
        out = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return F.relu(self.bn(out))


class NonBottleneck1d(nn.Module):
    def __init__(self, c: int, dilated: int, gen=None):
        super().__init__()
        d = dilated
        self.conv3x1_1 = L.Conv2d(c, c, (3, 1), padding=(1, 0), gen=gen)
        self.conv1x3_1 = L.Conv2d(c, c, (1, 3), padding=(0, 1), gen=gen)
        self.bn1 = L.BatchNorm(c, eps=_BN_EPS)
        self.conv3x1_2 = L.Conv2d(c, c, (3, 1), padding=(d, 0),
                                  dilation=(d, 1), gen=gen)
        self.conv1x3_2 = L.Conv2d(c, c, (1, 3), padding=(0, d),
                                  dilation=(1, d), gen=gen)
        self.bn2 = L.BatchNorm(c, eps=_BN_EPS)

    def forward(self, x):
        out = F.relu(self.conv3x1_1(x))
        out = F.relu(self.bn1(self.conv1x3_1(out)))
        out = F.relu(self.conv3x1_2(out))
        out = self.bn2(self.conv1x3_2(out))
        return F.relu(out + x)


class Upsampler(nn.Module):
    def __init__(self, cin: int, cout: int, gen=None):
        super().__init__()
        self.conv = L.ConvTranspose2d(cin, cout, 3, 2, 1, 1, bias=True,
                                      gen=gen)
        self.bn = L.BatchNorm(cout, eps=_BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


# block schedules, as lav_tpu's _ENC_BLOCKS / _DEC_BLOCKS
_ENC_BLOCKS = (
    [("nb", 64, 1)] * 5
    + [("down", 64, 128)]
    + [("nb", 128, 2), ("nb", 128, 4), ("nb", 128, 8), ("nb", 128, 16)] * 2
)
_DEC_BLOCKS = [("up", 128, 64), ("nb", 64, 1), ("nb", 64, 1),
               ("up", 64, 16), ("nb", 16, 1), ("nb", 16, 1)]


def _block(spec, gen):
    if spec[0] == "nb":
        return NonBottleneck1d(spec[1], spec[2], gen=gen)
    cls = Downsampler if spec[0] == "down" else Upsampler
    return cls(spec[1], spec[2], gen=gen)


class ERFNet(nn.Module):
    """x (B, 3, H, W) normalised to [-1, 1] -> logits (B, classes, H, W)."""

    def __init__(self, num_classes: int, gen=None):
        super().__init__()
        self.initial = Downsampler(3, 16, gen=gen)
        self.enc_down0 = Downsampler(16, 64, gen=gen)
        self.block_names = []
        for prefix, specs in (("enc", _ENC_BLOCKS), ("dec", _DEC_BLOCKS)):
            for i, spec in enumerate(specs):
                setattr(self, f"{prefix}_{i}", _block(spec, gen))
                self.block_names.append(f"{prefix}_{i}")
        self.output_conv = L.ConvTranspose2d(16, num_classes, 2, 2, 0, 0,
                                             bias=True, gen=gen)

    def forward(self, x):
        out = self.enc_down0(self.initial(x))
        for name in self.block_names:
            out = getattr(self, name)(out)
        return self.output_conv(out)
