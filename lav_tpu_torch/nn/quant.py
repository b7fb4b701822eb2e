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
max over calls).  `LAV_INT8_UPCONV`'s `conv_transpose2d_int8` and
`LAV_S2D_CROPS`'s `conv2d_int8_s2d` are default-off in lav_tpu and not
ported.
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


def quantize_tree(module, *, min_channels: int = 16):
    """Switch every forward conv under `module` with at least
    `min_channels` input channels to int8, skipping the `_SKIP_KEYS`
    subtrees; returns `module`."""
    from lav_tpu_torch.nn.layers import Conv2d

    def walk(m):
        for name, child in m.named_children():
            if _SKIP_KEYS.match(name):
                continue
            if isinstance(child, Conv2d):
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


def _out_hw(H, W, KH, KW, stride, padding, dilation):
    OH = (H + 2 * padding[0] - dilation[0] * (KH - 1) - 1) // stride[0] + 1
    OW = (W + 2 * padding[1] - dilation[1] * (KW - 1) - 1) // stride[1] + 1
    return OH, OW


# the plain version sums in f32 over input-channel chunks small enough that
# every partial sum is an integer below 2^24 (127 * 127 * taps * chunk),
# so each chunk's conv is exact in any summation order; chunks add in int32
_EXACT_F32 = 2 ** 24


def conv2d_int8_plain(xq, w_int8, w_scale, s_x, b, stride, padding,
                      dilation, out_dtype):
    """Plain version of kernel `conv2d_int8`: xq (N, H, W, C) int8, w_int8
    (O, KH, KW, C) int8, w_scale (O,) f32, s_x 0-dim f32, b (O,) or None
    -> (N, OH, OW, O) out_dtype.  The int32 sum is exact."""
    O, KH, KW, C = w_int8.shape
    chunk = max(1, (_EXACT_F32 - 1) // (127 * 127 * KH * KW))
    x = xq.permute(0, 3, 1, 2)
    w = w_int8.permute(0, 3, 1, 2)
    acc = None
    # cuDNN may pick Winograd or FFT, which are not exact; PyTorch's own
    # im2col + GEMM (and the CPU's direct conv) are
    with torch.backends.cudnn.flags(enabled=False):
        for c0 in range(0, C, chunk):
            part = F.conv2d(x[:, c0:c0 + chunk].float(),
                            w[:, c0:c0 + chunk].float(), None, stride,
                            padding, dilation).to(torch.int32)
            acc = part if acc is None else acc + part
    y = acc.float() * (s_x * w_scale)[:, None, None]
    if b is not None:
        y = y + b.float()[:, None, None]
    return y.to(out_dtype).permute(0, 2, 3, 1)


_OUT = {torch.bfloat16: "bf16", torch.float32: "f32"}


def conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding, dilation,
                     out_dtype):
    """Kernel `conv2d_int8` (contract of `conv2d_int8_plain`); stride,
    padding and dilation are (h, w) pairs.  CPU tensors take the plain
    version."""
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, w_int8, w_scale, s_x, b, stride,
                                 padding, dilation, out_dtype)
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
    OH, OW = _out_hw(H, W, KH, KW, stride, padding, dilation)
    xq = xq.contiguous()
    w_scale = w_scale.float().contiguous()
    s_x = s_x.float().reshape(1).contiguous()
    bias = None if b is None else b.float().contiguous()
    if xq.data_ptr() % 16 or w_int8.data_ptr() % 16 or \
            not w_int8.is_contiguous():
        raise ValueError("conv2d_int8: x and w must be contiguous and "
                         "16-byte aligned")
    out = torch.empty((N, OH, OW, O), dtype=out_dtype, device=dev)
    geom = (ctypes.c_int * 15)(N, H, W, C, O, KH, KW, stride[0], stride[1],
                               padding[0], padding[1], dilation[0],
                               dilation[1], OH, OW)
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
