"""Camera models, inference (counterpart of `lav_tpu/models/rgb.py`):
ERFNet segmentation with (x/255 - 0.5) * 2 input normalisation, and the
brake predictor — an ImageNet-normalised ResNet-18 over the wide
triple-camera concat and the telephoto image, pooled by global average
(v1) or single-query attention (v2).  The brake net's auxiliary
segmentation head only serves training and is not ported here."""

from __future__ import annotations

import torch
from torch import nn

from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.attention import AttentionPool
from lav_tpu_torch.nn.erfnet import ERFNet
from lav_tpu_torch.nn.resnet import resnet18, resnet_apply

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SegModel(nn.Module):
    def __init__(self, num_seg_channels: int, gen=None):
        super().__init__()
        self.erfnet = ERFNet(num_seg_channels + 1, gen=gen)

    def forward(self, rgb):
        """rgb (B, H, W, 3) 0-255 floats -> logits (B, H, W, classes)."""
        x = (rgb / 255.0 - 0.5) * 2.0
        return L.nchw_to_nhwc(self.erfnet(L.nhwc_to_nchw(x)))


class BrakeModel(nn.Module):
    jax_unused = ("seg_head",)  # the training-time auxiliary head

    def __init__(self, version: int = 1, gen=None):
        super().__init__()
        self.version = version
        self.conv_backbone = resnet18(3, gen=gen)
        self.classifier = L.Linear(1024, 1, gen=gen)
        if version == 2:
            self.attn1 = AttentionPool(512, gen=gen)
            self.attn2 = AttentionPool(512, gen=gen)

    def forward(self, rgb1, rgb2):
        """rgb1 wide concat (B, H, W, 3), rgb2 telephoto (B, H2, W2, 3),
        0-255 floats -> brake probability (B,)."""
        def norm(x):
            mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
            return (x / 255.0 - mean) / std

        x1 = resnet_apply(self.conv_backbone, norm(rgb1))
        x2 = resnet_apply(self.conv_backbone, norm(rgb2))
        if self.version == 2:
            h1, h2 = self.attn1(x1), self.attn2(x2)
        else:
            h1, h2 = x1.mean(dim=(1, 2)), x2.mean(dim=(1, 2))
        return torch.sigmoid(self.classifier(torch.cat([h1, h2], -1)))[:, 0]
