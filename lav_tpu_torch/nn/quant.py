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

The kernel takes every form as a phase plan (`conv_plan`): per axis, the
conv over the dilated input splits into output phases, each an ordinary
conv of the undilated input over only the taps that land on real pixels,
so a transposed conv walks no inserted zero.  `conv_tiles` picks the
launch's tile.  Both are pure functions of the shapes, held on the CPU by
`tests/test_torch_conv_plan.py`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re

import torch
import torch.nn.functional as F

from lav_tpu_torch.utils import native

# subtrees that stay float (lav_tpu/nn/quant.py:66), by the port's module
# names, which are lav_tpu's params keys: the brake net's seg head's and
# the lidar heads' transposed convs (`up1`-`up3`, `up`), the lidar
# backbone's `upconv1`-`upconv3` and entry block `conv1_0`, ERFNet's
# `output_conv`.  ERFNet's decoder upsamplers (`dec_i.conv`) are walked,
# as lav_tpu walks their keys, and go int8 under the whole-tree scope.
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
    r"^upconv\\d$"); a transposed conv outside them (ERFNet's decoder
    upsamplers) goes int8 as lav_tpu's conv_transpose2d_int8.  Returns
    `module`."""
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


# csrc/conv2d_int8.cu's limits: phases and taps per axis, bytes of K per
# step, and the channel multiple of its 16-byte chunks
MAX_PHASES = 16
MAX_TAPS = 16
BK = 128
C_MULTIPLE = 16
# csrc/conv2d_int8.cu's tiles, (BM, BN) -> stages of its ring (`Stages`)
TILES = {(256, 64): 5, (128, 128): 6, (128, 64): 4}
# an O = 64 conv with more K steps than this takes the 256 x 64 tile
LONG_K = 64


def axis_plan(n, k, stride, pads, dilation, lhs):
    """One axis of the conv over the input of size n dilated by `lhs`,
    padded by pads (before, after), with kernel size k, stride and kernel
    dilation -> (out, P, s', phases): output r + P*j of phase r (j <
    n_out) sums taps t, each reading input row j*s' + off, over
    phases = ((n_out, ((t, off), ...)), ...) for r in range(P)."""
    out = ((n - 1) * lhs + 1 + pads[0] + pads[1] - dilation * (k - 1) - 1) \
        // stride + 1
    g = math.gcd(stride, lhs)
    P = lhs // g
    phases = []
    for r in range(P):
        pos = [r * stride - pads[0] + t * dilation for t in range(k)]
        taps = tuple((t, u // lhs) for t, u in enumerate(pos)
                     if u % lhs == 0)
        phases.append((max(0, -(-(out - r) // P)), taps))
    return out, P, stride // g, tuple(phases)


def conv_tiles(m, o, phases, ksteps, sms=132):
    """(BM, BN) of the launch for m outputs (the largest phase's), o
    channels and ksteps steps of K: 128 x 128 where O > 64, 256 x 64 where
    O <= 64 and K is long (> LONG_K steps: B is re-read per m-tile), if its
    grid of m-tiles x n-tiles x phases fills `sms` SMs; else 128 x 64 (two
    blocks an SM)."""
    big = (128, 128) if o > 64 else (256, 64) if ksteps > LONG_K else None
    tile = big if big and -(-m // big[0]) * -(-o // big[1]) * phases >= sms \
        else (128, 64)
    assert tile in TILES
    return tile


def conv_plan(N, H, W, C, O, KH, KW, stride, padding, dilation,
              lhs_dilation, sms=132):
    """The launch plan of kernel `conv2d_int8`: {"axes": (axis_plan of y,
    of x), "tile": (BM, BN)}."""
    pads = _pads(padding)
    axes = tuple(axis_plan(n, k, s, p, d, l) for n, k, s, p, d, l in zip(
        (H, W), (KH, KW), stride, pads, dilation, lhs_dilation))
    m = N * max(ny for ny, _ in axes[0][3]) * max(nx for nx, _ in axes[1][3])
    kbytes = max(len(ty) for _, ty in axes[0][3]) * max(
        len(tx) for _, tx in axes[1][3]) * C
    tile = conv_tiles(m, O, axes[0][1] * axes[1][1], -(-kbytes // BK), sms)
    return {"axes": axes, "tile": tile}


@functools.lru_cache(maxsize=256)
def _plan_ints(N, H, W, C, O, KH, KW, stride, padding, dilation,
               lhs_dilation, sms):
    """(OH, OW, the plan as csrc/conv2d_int8.cu's `Plan`: 591 C ints), or
    raise if the kernel's tables cannot hold it.  Each tap goes as one int,
    its input offset * 65536 + its kernel index."""
    plan = conv_plan(N, H, W, C, O, KH, KW, stride, padding, dilation,
                     lhs_dilation, sms)
    (OH, P_y, s_y, ys), (OW, P_x, s_x, xs) = plan["axes"]
    if max(P_y, P_x) > MAX_PHASES or any(
            len(taps) > MAX_TAPS for _, taps in ys + xs):
        raise ValueError(f"conv2d_int8: {P_y}x{P_x} phases or more than "
                         f"{MAX_TAPS} taps per phase and axis (kernel "
                         f"{KH}x{KW}, input dilation {lhs_dilation})")
    if any(not -2 ** 15 <= off < 2 ** 15 for _, taps in ys + xs
           for _, off in taps):
        raise ValueError(f"conv2d_int8: a tap offset beyond +-32767 "
                         f"(padding {padding})")
    ints = [N, H, W, C, O, KH, KW, OH, OW, P_y, P_x, s_y, s_x, *plan["tile"]]
    for phases in (ys, xs):
        rows = list(phases) + [(0, ())] * (MAX_PHASES - len(phases))
        ints += [n for n, _ in rows] + [len(t) for _, t in rows]
        for _, taps in rows:
            ints += [off * 65536 + k for k, off in taps] + [0] * (
                MAX_TAPS - len(taps))
    return OH, OW, (ctypes.c_int * len(ints))(*ints)


@functools.lru_cache(maxsize=16)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


_ENTRY = {torch.bfloat16: native.ENTRIES["conv2d_int8_bf16"],
          torch.float32: native.ENTRIES["conv2d_int8_f32"]}


def _refuse(xq, w_int8, tensors, out_dtype):
    """Raise with what makes the inputs unfit for kernel `conv2d_int8`."""
    dev = xq.device
    if dev.type != "cuda" or any(t is not None and t.device != dev
                                 for t in tensors):
        raise ValueError("conv2d_int8: every input must be on one CUDA "
                         f"device (activations on {dev})")
    if xq.dtype != torch.int8 or w_int8.dtype != torch.int8:
        raise TypeError(f"conv2d_int8: x {xq.dtype}, w {w_int8.dtype} "
                        "(int8)")
    if out_dtype not in _ENTRY:
        raise TypeError(f"conv2d_int8: output {out_dtype} (bf16/f32)")
    raise ValueError(f"conv2d_int8: x {tuple(xq.shape)}, w "
                     f"{tuple(w_int8.shape)}; NHWC and OHWI, C must match")


def pad_channels(t):
    """t (..., C) with zero channels appended up to a multiple of
    C_MULTIPLE (t itself where C is one).  A zero channel adds 0 to every
    int32 sum, so the conv over padded operands is exact."""
    extra = -t.shape[-1] % C_MULTIPLE
    return F.pad(t, (0, extra)) if extra else t


def _kernel_weight(w_int8):
    """pad_channels(w_int8), made once per weight tensor and kept on it
    while its contents stay the same."""
    if w_int8.shape[-1] % C_MULTIPLE == 0:
        return w_int8
    kept = getattr(w_int8, "_c_padded", None)
    if kept is None or kept[0] != w_int8._version:
        kept = (w_int8._version, pad_channels(w_int8).contiguous())
        w_int8._c_padded = kept
    return kept[1]


def conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding, dilation,
                     out_dtype, lhs_dilation=(1, 1)):
    """Kernel `conv2d_int8`: see `_conv2d_int8_nhwc`; while
    `native.exporting()` is on, through its custom op."""
    if native.EXPORTING:
        return _conv_op(xq, w_int8, w_scale, s_x, b, list(stride),
                        [p for pair in _pads(padding) for p in pair],
                        list(dilation), out_dtype, list(lhs_dilation))
    return _conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding,
                             dilation, out_dtype, lhs_dilation)


def _conv_impl(xq: torch.Tensor, w_int8: torch.Tensor, w_scale: torch.Tensor,
               s_x: torch.Tensor, b: torch.Tensor | None, stride: list[int],
               padding: list[int], dilation: list[int],
               out_dtype: torch.dtype, lhs_dilation: list[int]
               ) -> torch.Tensor:
    return _conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride,
                             (padding[:2], padding[2:]), dilation, out_dtype,
                             lhs_dilation)


def _conv_fake(xq, w_int8, w_scale, s_x, b, stride, padding, dilation,
               out_dtype, lhs_dilation):
    N, H, W, _ = xq.shape
    O, KH, KW, _ = w_int8.shape
    OH, OW = (axis_plan(n, k, s, p, d, lh)[0] for n, k, s, p, d, lh in zip(
        (H, W), (KH, KW), stride, (padding[:2], padding[2:]), dilation,
        lhs_dilation))
    return xq.new_empty((N, OH, OW, O), dtype=out_dtype)


def _conv2d_int8_nhwc(xq, w_int8, w_scale, s_x, b, stride, padding,
                      dilation, out_dtype, lhs_dilation=(1, 1)):
    """Kernel `conv2d_int8` (contract of `conv2d_int8_plain`); stride,
    dilation and lhs_dilation are (h, w) pairs, padding (h, w) or ((top,
    bottom), (left, right)).  CPU tensors take the plain version.  On CUDA
    a C that is not a multiple of C_MULTIPLE (16) is padded with zero
    channels (`pad_channels`; the weight's padded copy is made once and
    kept), which leaves the int32 sums exact.  The kernel's tables hold
    at most MAX_PHASES (16) output phases per axis (lhs_dilation /
    gcd(stride, lhs_dilation)) and MAX_TAPS (16) taps per phase and axis
    (a direct conv of kernel size up to 16, a transposed one of about 16
    taps per stride): a larger conv raises ValueError."""
    dev = xq.get_device()
    entry = _ENTRY.get(out_dtype)
    # one test on the fast path; _refuse says what is wrong
    if not (xq.is_cuda and entry is not None and xq.dtype is torch.int8
            and w_int8.dtype is torch.int8 and xq.dim() == 4
            and w_int8.dim() == 4 and w_int8.shape[3] == xq.shape[3]
            and w_int8.get_device() == dev
            and w_scale.get_device() == dev and s_x.get_device() == dev
            and (b is None or b.get_device() == dev)):
        if xq.device.type == "cpu":
            return conv2d_int8_plain(xq, w_int8, w_scale, s_x, b, stride,
                                     padding, dilation, out_dtype,
                                     lhs_dilation)
        _refuse(xq, w_int8, [w_int8, w_scale, s_x, b], out_dtype)
    if xq.shape[3] % C_MULTIPLE:
        xq, w_int8 = pad_channels(xq), _kernel_weight(w_int8)
    N, H, W, C = xq.shape
    O, KH, KW, _ = w_int8.shape
    if min(lhs_dilation) < 1:
        raise ValueError(f"conv2d_int8: lhs_dilation {lhs_dilation}")
    OH, OW, plan = _plan_ints(N, H, W, C, O, KH, KW, tuple(stride),
                              _pads(padding), tuple(dilation),
                              tuple(lhs_dilation), _sm_count(dev))
    if OH < 1 or OW < 1:
        raise ValueError(f"conv2d_int8: empty output {OH}x{OW}")
    xq = xq.contiguous()
    w_scale = w_scale.float().contiguous()
    s_x = s_x.float().reshape(1).contiguous()
    bias = None if b is None else b.float().contiguous()
    if xq.data_ptr() % 16 or w_int8.data_ptr() % 16 or \
            not w_int8.is_contiguous():
        raise ValueError("conv2d_int8: x and w must be contiguous and "
                         "16-byte aligned")
    out = xq.new_empty((N, OH, OW, O), dtype=out_dtype)
    native.launch(entry, dev, xq.data_ptr(), w_int8.data_ptr(),
                  w_scale.data_ptr(), s_x.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  plan)
    return out


# the conv as a custom op (`native.custom_op`), for export
_conv_op = native.custom_op("conv2d_int8", _conv_impl, _conv_fake)
