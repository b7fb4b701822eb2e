"""int8 inference for the conv stacks (counterpart of `lav_tpu/nn/quant.py`).

Hosts kernel `conv2d_int8` (csrc/conv2d_int8.cu).  The device of the
activations decides the route: a CUDA tensor launches the kernel (or the
wrapper raises), a CPU tensor takes the plain version `conv2d_int8_plain`.

Scheme, as lav_tpu's:
  * weights: per-output-channel symmetric absmax int8, quantized once by
    `quantize_tree`, which switches each eligible `layers.Conv2d` to its
    int8 form (buffers `w_int8` in OHWI layout, `w_scale` (O,) f32, and
    `x_scale`, the static activation scale, once calibrated);
  * activations: the static `x_scale` when the conv has one, otherwise a
    dynamic per-tensor absmax/127 floored at 1e-12, computed per call;
  * int32 accumulation, dequantized as float(acc) * (s_x * w_scale), then
    + b, then a cast.

`calibrate` runs a forward in observer mode: every int8 conv it reaches
records max(absmax, 1e-12)/127 of its input into its own `x_scale` (the
max over calls).

lav_tpu's two default-off forms run through the same kernel:
  * `conv2d_int8_s2d` (`LAV_S2D_CROPS=1`): the crop ResNet's 7x7 stride-2
    conv1 as a 4x4 stride-1 conv over space-to-depth int8 crops, with a
    weight derived from conv1's (embedded at +1 in 8x8, blocked 2x2) and
    padding ((2, 1), (2, 1));
  * `conv_transpose2d_int8` (`LAV_INT8_UPCONV=1`, `quantize_tree(include=
    r"^upconv\\d$")`): an int8 `layers.ConvTranspose2d` as the equivalent
    conv over its input dilated by the stride, with the flipped kernel and
    padding (k-1-p, k-1-p+output_padding) per axis.
"""

from __future__ import annotations

import ctypes
import re

import torch
import torch.nn.functional as F

from lav_tpu_torch.utils import native

# subtrees that stay float (lav_tpu/nn/quant.py:68): transposed convs and
# the lidar backbone's entry block
_SKIP_KEYS = re.compile(r"^(up\d*|upconv\d*|output_conv|conv1_0)$")

_CALIBRATING = False


def quantize_conv(w):
    """Float conv weight w (O, I, KH, KW) -> (w_int8 (O, KH, KW, I),
    w_scale (O,) f32): per-output-channel absmax / 127, floored at 1e-12,
    w_int8 = clip(round(w / scale), +-127) with round-half-to-even."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return wq.to(torch.int8).permute(0, 2, 3, 1).contiguous(), scale


def quantize_tree(module, *, min_channels: int = 16, include=None):
    """Switch every conv under `module` with at least `min_channels` input
    channels to int8, skipping the `_SKIP_KEYS` subtrees unless their name
    matches `include` (a regex; lav_tpu's `LAV_INT8_UPCONV=1` passes
    r"^upconv\\d$"); a transposed conv is reached only through such a
    subtree.  Returns `module`."""
    from lav_tpu_torch.nn.layers import Conv2d, ConvTranspose2d

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
        conv.x_scale = torch.tensor(max(prev, max(amax, 1e-12) / 127.0),
                                    dtype=torch.float32, device=x.device)
        return conv.x_scale
    if conv.x_scale is not None:
        return conv.x_scale
    return torch.clamp(x.float().abs().max() / 127.0, min=1e-12)


def quantize_act(x, s_x):
    """clip(round(x / s_x), +-127) as int8, half to even."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(
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


def _out_hw(H, W, KH, KW, stride, padding, dilation, lhs_dilation):
    """Output size over the input dilated by `lhs_dilation` and padded by
    `padding` ((top, bottom), (left, right))."""
    out = []
    for n, k, s, (p0, p1), d, l in zip((H, W), (KH, KW), stride, padding,
                                       dilation, lhs_dilation):
        out.append(((n - 1) * l + 1 + p0 + p1 - d * (k - 1) - 1) // s + 1)
    return tuple(out)


# the plain version sums in f32 over input-channel chunks small enough that
# every partial sum is an integer below 2^24 (127 * 127 * taps * chunk),
# so each chunk's conv is exact in any summation order; chunks add in int32
_EXACT_F32 = 2 ** 24


def conv2d_int8_plain(xq, w_int8, w_scale, s_x, b, stride, padding,
                      dilation, out_dtype, lhs_dilation=(1, 1)):
    """Plain version of kernel `conv2d_int8`: xq (N, H, W, C) int8, w_int8
    (O, KH, KW, C) int8, w_scale (O,) f32, s_x 0-dim f32, b (O,) or None
    -> (N, OH, OW, O) out_dtype.  padding is (h, w) or ((top, bottom),
    (left, right)); lhs_dilation inserts zeros between input pixels.  The
    int32 sum is exact."""
    O, KH, KW, C = w_int8.shape
    chunk = max(1, (_EXACT_F32 - 1) // (127 * 127 * KH * KW))
    x = xq.permute(0, 3, 1, 2)
    lh, lw = lhs_dilation
    if (lh, lw) != (1, 1):
        N, _, H, W = x.shape
        xd = x.new_zeros((N, C, (H - 1) * lh + 1, (W - 1) * lw + 1))
        xd[:, :, ::lh, ::lw] = x
        x = xd
    (pt, pb), (pl, pr) = _pads(padding)
    x = F.pad(x, (pl, pr, pt, pb))
    w = w_int8.permute(0, 3, 1, 2)
    acc = None
    # cuDNN may pick Winograd or FFT, which are not exact; PyTorch's own
    # im2col + GEMM (and the CPU's direct conv) are
    with torch.backends.cudnn.flags(enabled=False):
        for c0 in range(0, C, chunk):
            part = F.conv2d(x[:, c0:c0 + chunk].float(),
                            w[:, c0:c0 + chunk].float(), None, stride, 0,
                            dilation).to(torch.int32)
            acc = part if acc is None else acc + part
    y = acc.float() * (s_x * w_scale)[:, None, None]
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1)


_OUT = {torch.bfloat16: "bf16", torch.float32: "f32"}


def conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding, dilation,
                     out_dtype, lhs_dilation=(1, 1)):
    """Kernel `conv2d_int8` (contract of `conv2d_int8_plain`); stride,
    dilation and lhs_dilation are (h, w) pairs, padding (h, w) or ((top,
    bottom), (left, right)).  CPU tensors take the plain version."""
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, w_int8, w_scale, s_x, b, stride,
                                 padding, dilation, out_dtype, lhs_dilation)
    dev = xq.device
    tensors = [w_int8, w_scale, s_x] + ([] if b is None else [b])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("conv2d_int8: every input must be on one CUDA "
                         f"device (activations on {dev})")
    if xq.dtype != torch.int8 or w_int8.dtype != torch.int8:
        raise TypeError(f"conv2d_int8: x {xq.dtype}, w {w_int8.dtype} "
                        "(int8)")
    if out_dtype not in _OUT:
        raise TypeError(f"conv2d_int8: output {out_dtype} (bf16/f32)")
    N, H, W, C = xq.shape
    O, KH, KW, Cw = w_int8.shape
    if Cw != C or C % 32:
        raise ValueError(f"conv2d_int8: x {tuple(xq.shape)}, w "
                         f"{tuple(w_int8.shape)}; C must match and be a "
                         "multiple of 32")
    pads = _pads(padding)
    OH, OW = _out_hw(H, W, KH, KW, stride, pads, dilation, lhs_dilation)
    if OH < 1 or OW < 1 or min(lhs_dilation) < 1:
        raise ValueError(f"conv2d_int8: empty output {OH}x{OW} or "
                         f"lhs_dilation {lhs_dilation}")
    xq = xq.contiguous()
    w_scale = w_scale.float().contiguous()
    s_x = s_x.float().reshape(1).contiguous()
    bias = None if b is None else b.float().contiguous()
    if xq.data_ptr() % 16 or w_int8.data_ptr() % 16 or \
            not w_int8.is_contiguous():
        raise ValueError("conv2d_int8: x and w must be contiguous and "
                         "16-byte aligned")
    out = torch.empty((N, OH, OW, O), dtype=out_dtype, device=dev)
    geom = (ctypes.c_int * 17)(N, H, W, C, O, KH, KW, stride[0], stride[1],
                               pads[0][0], pads[1][0], dilation[0],
                               dilation[1], lhs_dilation[0],
                               lhs_dilation[1], OH, OW)
    fn = getattr(_lib(), f"conv2d_int8_{_OUT[out_dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xq.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
                 s_x.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), geom, stream)
    native.check(err, "conv2d_int8")
    native.LAUNCHES["conv2d_int8"] += 1
    return out


def _lib():
    lib = native.load("conv2d_int8")
    for name in ("conv2d_int8_bf16", "conv2d_int8_f32"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib
