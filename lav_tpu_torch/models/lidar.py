"""LiDAR perception model (counterpart of `lav_tpu/models/lidar.py`): PointPillars, a three-stage strided conv
backbone whose transposed-conv up-projections concatenate to a 6*nf
half-resolution map, and four heads (center heatmap, box size,
orientation, BEV segmentation).  LAV's Conv -> ReLU -> BN order (BN eps
1e-3, momentum 0.01) is kept for weight parity.  In train mode every
BatchNorm normalises with its batch's statistics (the pillar MLP's over
the valid points only) and the pillar canvas is the differentiable
canvas max of `ops/pillar.py`.  lav_tpu's merged-head and 128-lane
canvas forms are TPU layout tactics with the same math; here each head
runs on its own.

Under int8 (`nn/quant.py`) the backbone convs and each head's 3x3 conv
run `conv2d_int8`; the entry block `conv1_0`, the `upconv*` blocks and
each head's `up` stay float, unless `quantize_tree(include=
r"^upconv\\d$")` (lav_tpu's `LAV_INT8_UPCONV=1`) turns the three
`upconv*` transposed convs int8 too.  lav_tpu merges the heads into one conv that
quantizes its shared input once, with the max of the four heads'
activation scales; each head here quantizes with that same max.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn import quant
from lav_tpu_torch.ops.pillar import PointPillar
from lav_tpu_torch.utils.tree import bn_state

_BN_EPS = 1e-3
_BN_MOMENTUM = 0.01   # LAV's BatchNorm2d(eps=1e-3, momentum=0.01)
_STAGES = ((4, 1), (6, 2), (6, 2))  # (n_convs, channel multiplier)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, stride, gen=None):
        super().__init__()
        self.conv = L.Conv2d(cin, cout, 3, stride, 1, bias=False, gen=gen)
        self.bn = L.BatchNorm(cout, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class UpConvBlock(nn.Module):
    def __init__(self, cin, cout, ksize, stride, padding, output_padding,
                 gen=None):
        super().__init__()
        self.conv = L.ConvTranspose2d(cin, cout, ksize, stride, padding,
                                      output_padding, bias=False, gen=gen)
        self.bn = L.BatchNorm(cout, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class Head(nn.Module):
    def __init__(self, cin, cout, hidden=64, gen=None):
        super().__init__()
        self.conv = L.Conv2d(cin, hidden, 3, 1, 1, bias=False, gen=gen)
        self.bn = L.BatchNorm(hidden, eps=_BN_EPS, momentum=_BN_MOMENTUM)
        self.up = L.ConvTranspose2d(hidden, cout, 3, 2, 1, 1, bias=True,
                                    gen=gen)

    def forward(self, x, x_scale=None):
        return self.up(self.bn(F.relu(self.conv(x, x_scale=x_scale))))


class Backbone(nn.Module):
    def __init__(self, nf: int, gen=None):
        super().__init__()
        self.stages = []
        cin = nf
        for s, (n_convs, mult) in enumerate(_STAGES):
            names = []
            for b in range(n_convs):
                name = f"conv{s + 1}_{b}"
                setattr(self, name, ConvBlock(cin, nf * mult,
                                              2 if b == 0 else 1, gen=gen))
                names.append(name)
                cin = nf * mult
            self.stages.append(names)
        self.upconv1 = UpConvBlock(nf, 2 * nf, 1, 1, 0, 0, gen=gen)
        self.upconv2 = UpConvBlock(2 * nf, 2 * nf, 4, 2, 1, 0, gen=gen)
        # LAV: ConvTranspose2d(k=4, stride=4, padding=1, output_padding=2)
        self.upconv3 = UpConvBlock(2 * nf, 2 * nf, 4, 4, 1, 2, gen=gen)

    def forward(self, x):
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return torch.cat([self.upconv1(outs[0]), self.upconv2(outs[1]),
                          self.upconv3(outs[2])], dim=1)


class LidarModel(nn.Module):
    """forward(points (B, P, D), valid (B, P), use_pallas=False) ->
    (features (B, ny/2, nx/2, 6nf) NHWC, heatmap logits, sizemaps,
    orimaps, bev_seg), the four maps channel-first (B, c, ny, nx) in the
    points' dtype; bev_seg through a sigmoid in f32.  `use_pallas` picks
    the pillar route of eval mode (ops/pillar.py); train mode has its own
    and adds the BN state to the outputs."""

    def __init__(self, num_input: int, num_features: Sequence[int], *,
                 min_x: float, max_x: float, min_y: float, max_y: float,
                 pixels_per_meter: float, gen=None):
        super().__init__()
        nf = num_features[-1]
        self.point_pillar = PointPillar(
            num_input, num_features, min_x=min_x, max_x=max_x, min_y=min_y,
            max_y=max_y, pixels_per_meter=pixels_per_meter, gen=gen)
        self.backbone = Backbone(nf, gen=gen)
        self.center_head = Head(6 * nf, 2, gen=gen)
        self.box_head = Head(6 * nf, 2, gen=gen)
        self.ori_head = Head(6 * nf, 2, gen=gen)
        self.seg_head = Head(6 * nf, 3, gen=gen)
        self.eval()   # inference unless a caller asks for train mode

    def forward(self, points, valid, use_pallas: bool = False):
        """In train mode the outputs are followed by the BN state
        (`utils/tree.py::bn_state`) of this forward."""
        canvas = self.point_pillar(points, valid, use_pallas=use_pallas)
        feats = self.backbone(L.nhwc_to_nchw(canvas))
        heads = (self.center_head, self.box_head, self.ori_head,
                 self.seg_head)
        x_scale = None
        if all(h.conv.w_int8 is not None for h in heads):
            x_nhwc = L.nchw_to_nhwc(feats)
            x_scale = torch.stack([quant.act_scale(h.conv, x_nhwc)
                                   for h in heads]).max()
        hm, box, ori, seg = (h(feats, x_scale=x_scale) for h in heads)
        out = (L.nchw_to_nhwc(feats), hm, box, ori,
               torch.sigmoid(seg.float()))
        return out + (bn_state(self),) if self.training else out
