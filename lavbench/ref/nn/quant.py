"""int8 inference for the conv stacks, in plain PyTorch: a frozen copy of
the port's quantization scheme, with its plain int8 conv.

Scheme:
  * weights: per-output-channel symmetric absmax, quantized once by
    `quantize_tree`, which switches each eligible `layers.Conv2d` to its
    int8 form (buffers `w_int8` in OHWI layout, `w_scale` (O,) f32, and
    `x_scale`, the static activation scale, once calibrated);
  * activations: the static `x_scale` when the conv has one, otherwise a
    dynamic per-tensor absmax/QMAX floored at 1e-12, computed per call;
  * integer sums, dequantized as float(acc) * (s_x * w_scale), then + b,
    then a cast.

`calibrate` runs a forward in observer mode: every int8 conv it reaches
records max(absmax, 1e-12)/QMAX of its input into its own `x_scale`.

QMAX is 127 (int8).  The correctness control sets it to 7, which makes
every quantized conv int4, the next precision below the configuration's.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from lavbench.ref import record


# subtrees that stay float (lav_tpu/nn/quant.py:66), by the port's module
# names, which are lav_tpu's params keys: the brake net's seg head's and
# the lidar heads' transposed convs (`up1`-`up3`, `up`), the lidar
# backbone's `upconv1`-`upconv3` and entry block `conv1_0`, ERFNet's
# `output_conv`.  ERFNet's decoder upsamplers (`dec_i.conv`) are walked,
# as lav_tpu walks their keys, and go int8 under the whole-tree scope.
_SKIP_KEYS = re.compile(r"^(up\d*|upconv\d*|output_conv|conv1_0)$")

_CALIBRATING = False
QMAX = 127


def quantize_conv(w):
    """Float conv weight w (O, I, KH, KW) -> (w_int8 (O, KH, KW, I),
    w_scale (O,) f32): per-output-channel absmax / QMAX, floored at
    1e-12, w_int8 = clip(round(w / scale), +-QMAX), half to even."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / QMAX, min=1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -QMAX,
                     QMAX)
    return wq.to(torch.int8).permute(0, 2, 3, 1).contiguous(), scale


def quantize_tree(module, *, min_channels: int = 16, include=None):
    """Switch every conv under `module` with at least `min_channels` input
    channels to int8, skipping the `_SKIP_KEYS` subtrees unless their name
    matches `include` (a regex; lav_tpu's `LAV_INT8_UPCONV=1` passes
    r"^upconv\\d$"); a transposed conv outside them (ERFNet's decoder
    upsamplers) goes int8 as lav_tpu's conv_transpose2d_int8.  Returns
    `module`."""
    from lavbench.ref.nn.layers import Conv2d, ConvTranspose2d

    if isinstance(include, str):
        include = re.compile(include)

    def walk(m):
        for name, child in m.named_children():
            if _SKIP_KEYS.match(name) and not (include is not None
                                               and include.match(name)):
                continue
            if isinstance(child, (Conv2d, ConvTranspose2d)):
                if child.cin >= min_channels and child.w_int8 is None:
                    child.quantize_()
            else:
                walk(child)

    walk(module)
    return module


def int8_convs(module):
    """(lav_tpu param path, conv) for every int8 conv under `module`; the
    path is '/'-joined keys from `module`, e.g. '/uniplanner/lidar_conv_emb/
    conv1' from the agent's models."""
    for name, m in module.named_modules():
        if getattr(m, "w_int8", None) is not None:
            yield "/" + name.replace(".", "/"), m


def calibrating() -> bool:
    return _CALIBRATING


def calibrate(run_once, *args, **kwargs):
    """Run `run_once(*args, **kwargs)` in observer mode and return its
    result: each int8 conv reached records its input's scale."""
    global _CALIBRATING
    _CALIBRATING = True
    try:
        return run_once(*args, **kwargs)
    finally:
        _CALIBRATING = False


def act_scale(conv, x):
    """The activation scale conv applies to float input x: observed in
    calibration, else the static `x_scale`, else dynamic."""
    if _CALIBRATING:
        amax = float(x.float().abs().max())
        prev = 0.0 if conv.x_scale is None else float(conv.x_scale)
        conv.x_scale = torch.tensor(max(prev, max(amax, 1e-12) / QMAX),
                                    dtype=torch.float32, device=x.device)
        return conv.x_scale
    if conv.x_scale is not None:
        return conv.x_scale
    return torch.clamp(x.float().abs().max() / QMAX, min=1e-12)


def quantize_act(x, s_x):
    """clip(round(x / s_x), +-QMAX) as int8, half to even."""
    return torch.clamp(torch.round(x.float() / s_x), -QMAX, QMAX).to(
        torch.int8)


def conv2d_int8_s2d(conv, x_s2d, out_dtype=torch.bfloat16):
    """lav_tpu's conv2d_int8_s2d: the int8 7x7 stride-2 padding-3 `conv`
    over space-to-depth int8 input x_s2d (B, H/2, W/2, 4C) in (dy, dx, c)
    channel order (kernel `crop_shared_q8_s2d`, quantized with conv's
    x_scale), as a 4x4 stride-1 conv with padding ((2, 1), (2, 1)): the same
    int32 sums as the direct conv on the un-reshuffled crops."""
    if conv.x_scale is None:
        raise ValueError("conv2d_int8_s2d: int8 input needs a calibrated "
                         "x_scale")
    return conv2d_int8_nhwc(x_s2d, conv.s2d_weight(), conv.w_scale,
                            conv.x_scale, conv.b, (1, 1), ((2, 1), (2, 1)),
                            (1, 1), out_dtype)


def s2d_weight(w_int8):
    """conv1's (O, 7, 7, C) int8 weight -> the (O, 4, 4, 4C) weight of the
    4x4 stride-1 conv over space-to-depth input (lav_tpu quant.py:230-234):
    embedded at +1 in 8x8, each 2x2 block folded into channels (dy, dx, c)."""
    O, KH, KW, C = w_int8.shape
    if KH > 7 or KW > 7:
        raise ValueError(f"s2d_weight: a {KH}x{KW} kernel does not fit 8x8")
    w8 = w_int8.new_zeros((O, 8, 8, C))
    w8[:, 1:1 + KH, 1:1 + KW] = w_int8
    w8 = w8.reshape(O, 4, 2, 4, 2, C).permute(0, 1, 3, 2, 4, 5)
    return w8.reshape(O, 4, 4, 4 * C).contiguous()


def conv_transpose2d_int8(conv, x):
    """lav_tpu's conv_transpose2d_int8 for an int8 `layers.ConvTranspose2d`
    on NHWC float x: x quantized with `act_scale`, then the conv over x
    dilated by the stride with the flipped kernel (conv.w_int8) and
    padding (k-1-p, k-1-p+output_padding) per axis; output in x's dtype."""
    pad = tuple((k - 1 - p, k - 1 - p + op) for k, p, op in zip(
        conv.ksize, conv.padding, conv.output_padding))
    s_x = act_scale(conv, x)
    return conv2d_int8_nhwc(quantize_act(x, s_x), conv.w_int8, conv.w_scale,
                            s_x, conv.b, (1, 1), pad, (1, 1), x.dtype,
                            lhs_dilation=conv.stride)


def conv2d_int8(conv, x, out_dtype=None, x_scale=None):
    """lav_tpu's conv2d_int8 for an int8 `layers.Conv2d` on NHWC x.

    An int8 x was quantized by its producer with conv.x_scale and is
    consumed as it is; the output defaults to bf16.  A float x is
    quantized with `x_scale` if given (the merged lidar heads' shared
    scale), else `act_scale`; the output defaults to x's dtype."""
    if x.dtype == torch.int8:
        if conv.x_scale is None:
            raise ValueError("conv2d_int8: int8 input needs a calibrated "
                             "x_scale")
        s_x, xq = conv.x_scale, x
        out_dtype = out_dtype or torch.bfloat16
    else:
        s_x = act_scale(conv, x) if x_scale is None else x_scale
        xq = quantize_act(x, s_x)
        out_dtype = out_dtype or x.dtype
    return conv2d_int8_nhwc(xq, conv.w_int8, conv.w_scale, s_x, conv.b,
                            conv.stride, conv.padding, conv.dilation,
                            out_dtype)


def _pads(padding):
    """(h, w) symmetric pads or ((top, bottom), (left, right)) -> the
    latter."""
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in padding)


def conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding, dilation,
                     out_dtype, lhs_dilation=(1, 1)):
    """The int8 conv: xq (N, H, W, C) int8, w_int8 (O, KH, KW, C) int8,
    w_scale (O,) f32, s_x 0-dim f32, b (O,) or None -> (N, OH, OW, O)
    out_dtype.  padding is (h, w) or ((top, bottom), (left, right));
    lhs_dilation inserts zeros between input pixels.  The integer sums are
    taken by an f32 conv (TF32 off), which rounds a sum above 2^24 by at
    most a part in 1e7."""
    O, KH, KW, C = w_int8.shape
    record.note("conv2d_int8", x=tuple(xq.shape), w=tuple(w_int8.shape),
                stride=tuple(stride), padding=_pads(padding),
                dilation=tuple(dilation), lhs=tuple(lhs_dilation),
                bias=b is not None, out_elem=torch.empty(
                    (), dtype=out_dtype).element_size())
    x = xq.permute(0, 3, 1, 2).float()
    lh, lw = lhs_dilation
    if (lh, lw) != (1, 1):
        N, _, H, W = x.shape
        xd = x.new_zeros((N, C, (H - 1) * lh + 1, (W - 1) * lw + 1))
        xd[:, :, ::lh, ::lw] = x
        x = xd
    (pt, pb), (pl, pr) = _pads(padding)
    x = F.pad(x, (pl, pr, pt, pb))
    acc = F.conv2d(x, w_int8.permute(0, 3, 1, 2).float(), None, stride, 0,
                   dilation)
    y = acc * (s_x.float() * w_scale.float())[:, None, None]
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1)
