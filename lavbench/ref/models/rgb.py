"""Camera models (counterpart of `lav_tpu/models/rgb.py`): ERFNet
segmentation with (x/255 - 0.5) * 2 input normalisation, and the brake
predictor — an ImageNet-normalised ResNet-18 over the wide triple-camera
concat and the telephoto image, pooled by global average (v1) or
single-query attention (v2), with the auxiliary segmentation head that
its train step reads (`with_mask=True`).

Both run in the module's mode: eval (a new module's) for inference,
`.train()` for the train steps of `train/privileged.py` (BatchNorm on
batch statistics; ERFNet's dropout)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lavbench.ref.nn import layers as L
from lavbench.ref.nn.attention import AttentionPool
from lavbench.ref.nn.erfnet import ERFNet
from lavbench.ref.nn.resnet import resnet18, resnet_apply

BRAKE_SEG_CHANNELS = 3   # every lav_tpu caller: 3 seg channels + background
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SegModel(nn.Module):
    def __init__(self, num_seg_channels: int, gen=None):
        super().__init__()
        self.erfnet = ERFNet(num_seg_channels + 1, gen=gen)

    def forward(self, rgb, masks=None, gen=None):
        """rgb (B, H, W, 3) 0-255 floats -> logits (B, H, W, classes).
        In train mode ERFNet drops out with `masks` or masks drawn from
        `gen` (`ERFNet.forward`)."""
        x = (rgb / 255.0 - 0.5) * 2.0
        return L.nchw_to_nhwc(self.erfnet(L.nhwc_to_nchw(x), masks, gen))


class SegHead(nn.Module):
    """The brake net's auxiliary segmentation head (lav_tpu `_seg_head`):
    three ConvTranspose2d(3, stride 2, padding 1, output_padding 1) +
    BatchNorm + ReLU stages (256, 128, 64 channels), then a 1x1 conv.
    x (B, H, W, cin) NHWC -> logits (B, 8H, 8W, num_labels)."""

    def __init__(self, cin: int, num_labels: int, gen=None):
        super().__init__()
        for i, (ci, co) in enumerate(((cin, 256), (256, 128), (128, 64)), 1):
            setattr(self, f"up{i}", L.ConvTranspose2d(ci, co, 3, 2, 1, 1,
                                                      bias=True, gen=gen))
            setattr(self, f"bn{i}", L.BatchNorm(co))
        self.out = L.Conv2d(64, num_labels, 1, bias=True, gen=gen)

    def forward(self, x):
        x = L.nhwc_to_nchw(x)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"up{i}")(x)))
        return L.nchw_to_nhwc(self.out(x))


class BrakeModel(nn.Module):
    """`imagenet_sd`: a torchvision resnet18 state_dict (numpy arrays) for
    the ImageNet-pretrained backbone LAV starts from (lav_tpu's
    `brake_model_init(imagenet_sd=...)`), converted by
    `utils/weights.py::convert_resnet`; the other parameters come from
    `gen` either way."""

    def __init__(self, version: int = 1, gen=None, imagenet_sd=None):
        super().__init__()
        self.version = version
        self.conv_backbone = resnet18(3, gen=gen)
        self.classifier = L.Linear(1024, 1, gen=gen)
        if version == 2:
            self.attn1 = AttentionPool(512, gen=gen)
            self.attn2 = AttentionPool(512, gen=gen)
        self.seg_head = SegHead(512, BRAKE_SEG_CHANNELS + 1, gen=gen)
        # not lav_tpu params: the input normalisation's constants, kept on
        # the module's device (f32; their bf16 casts equal the bf16
        # roundings of the decimal constants)
        self.register_buffer("imagenet_mean", torch.tensor(_IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("imagenet_std", torch.tensor(_IMAGENET_STD),
                             persistent=False)

    def forward(self, rgb1, rgb2, with_mask: bool = False):
        """rgb1 wide concat (B, H, W, 3), rgb2 telephoto (B, H2, W2, 3),
        0-255 floats -> brake probability (B,); with `with_mask` also the
        seg head's logits of each, upsampled x4 nearest to the input's
        size: (pred, sem1 (B, H, W, labels), sem2 (B, H2, W2, labels)).
        The backbone runs on rgb1, then rgb2, and the head on each in the
        same order, as lav_tpu calls them, so that in train mode the
        telephoto call's BatchNorm update is the one kept."""
        def norm(x):
            return ((x / 255.0 - self.imagenet_mean.to(x.dtype))
                    / self.imagenet_std.to(x.dtype))

        x1 = resnet_apply(self.conv_backbone, norm(rgb1))
        x2 = resnet_apply(self.conv_backbone, norm(rgb2))
        if self.version == 2:
            h1, h2 = self.attn1(x1), self.attn2(x2)
        else:
            h1, h2 = x1.mean(dim=(1, 2)), x2.mean(dim=(1, 2))
        pred = torch.sigmoid(self.classifier(torch.cat([h1, h2], -1)))[:, 0]
        if not with_mask:
            return pred
        sem1 = L.interpolate_nearest(self.seg_head(x1), 4)
        sem2 = L.interpolate_nearest(self.seg_head(x2), 4)
        return pred, sem1, sem2
