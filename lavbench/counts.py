"""The least work of the measured functions, from their shapes: the
operations and bytes each call needs (each input byte read once, each
output byte written once) and the least time at the H100's published
peaks.  Frozen from `chip_smoke.py` (`bound_ms`, `crop_bytes`) and made
independent of the kernel that implements a function."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAKS = {"int8": 1979e12, "bfloat16": 989e12, "tf32": 495e12,
         "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_CARD = "NVIDIA H100 SXM, 700 W"


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least seconds of a call: the larger of its bytes over the HBM
    bandwidth and its operations over `peak`."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def _taps(n_in: int, k: int, stride: int, pads, dilation: int, lhs: int):
    """(output size, kernel taps that land on real input pixels, summed
    over the output positions) of one axis of a conv over the input
    dilated by `lhs`."""
    size = (n_in - 1) * lhs + 1
    lo, hi = pads
    n_out = (size + lo + hi - dilation * (k - 1) - 1) // stride + 1
    real = 0
    for o in range(n_out):
        for t in range(k):
            p = o * stride + t * dilation - lo
            if 0 <= p < size and p % lhs == 0:
                real += 1
    return n_out, real


def conv2d_int8(info: dict):
    """(ops, bytes, dense ops) of one int8 conv call: ops counts the
    multiply-adds of the taps on real pixels twice; dense ops counts every
    tap."""
    N, H, W, C = info["x"]
    O, KH, KW, _ = info["w"]
    oh, real_h = _taps(H, KH, info["stride"][0], info["padding"][0],
                       info["dilation"][0], info["lhs"][0])
    ow, real_w = _taps(W, KW, info["stride"][1], info["padding"][1],
                       info["dilation"][1], info["lhs"][1])
    ops = 2 * N * O * C * real_h * real_w
    dense = 2 * N * O * C * oh * ow * KH * KW
    nbytes = (N * H * W * C + O * KH * KW * C + O * 4 + 4
              + (O * 4 if info["bias"] else 0)
              + N * oh * ow * O * info["out_elem"])
    return ops, nbytes, dense


def crop_pixels(src, grid) -> int:
    """Source pixels the taps of a crop read, each once, per item (the
    origin clamped as the kernels clamp it)."""
    B, H, W, _ = src.shape
    g = torch.nan_to_num(grid.detach().float())
    x0 = torch.clamp(torch.floor((g[..., 0] + 1.0) * 0.5 * (W - 1)), 0,
                     W - 2).long()
    y0 = torch.clamp(torch.floor((g[..., 1] + 1.0) * 0.5 * (H - 1)), 0,
                     H - 2).long()
    base = (y0 * W + x0).reshape(B, -1)
    return sum(torch.unique(torch.cat([t, t + 1, t + W, t + W + 1]))
               .numel() for t in base)


def crop(info: dict):
    """(ops, bytes) of one crop forward: four taps a channel, a multiply
    and an add each, on the source pixels it reads, the grid and the
    output (int8 with q8)."""
    src, grid = info["src"], info["grid"]
    C, e = src.shape[-1], src.element_size()
    outs = grid[..., 0].numel()
    out_elem = 1 if info["q8"] else e
    ops = 8 * outs * C
    nbytes = crop_pixels(src, grid) * C * e + grid.numel() * 4 \
        + outs * C * out_elem
    return ops, nbytes


def crop_bwd(info: dict):
    """(ops, bytes) of one crop's backward with respect to its source: the
    output's gradient and the grid read, the source's gradient written."""
    src, grid = info["src"], info["grid"]
    C, e = src.shape[-1], src.element_size()
    outs = grid[..., 0].numel()
    return 8 * outs * C, outs * C * e + grid.numel() * 4 + src.numel() * e


def tally(calls) -> dict:
    """Least seconds and work of recorded calls (`ref.record.CALLS`):
    conv2d_int8, crop (forward) and crop_bwd (the crops with a gradient)
    least seconds, and the int8 convs' dense ops (for the mfu)."""
    out = dict(conv2d_int8=0.0, crop=0.0, crop_bwd=0.0, int8_dense_ops=0.0,
               int8_ops=0.0)
    for kind, info in calls:
        if kind == "conv2d_int8":
            ops, nbytes, dense = conv2d_int8(info)
            out["conv2d_int8"] += bound_s(nbytes, ops, PEAKS["int8"])
            out["int8_ops"] += ops
            out["int8_dense_ops"] += dense
        elif kind == "crop":
            ops, nbytes = crop(info)
            out["crop"] += bound_s(nbytes, ops, PEAKS["float32"])
            if info["grad"]:
                ops, nbytes = crop_bwd(info)
                out["crop_bwd"] += bound_s(nbytes, ops, PEAKS["float32"])
    return out


def step_least_s(flops: float, int8_dense_ops: float, int8_ops: float,
                 precision_peak: float) -> float:
    """Least seconds of a whole tick or step: the int8 convs' ops at the
    int8 peak, every other counted FLOP (FlopCounterMode's count, which
    holds the int8 convs at their dense count) at the configuration's
    precision."""
    return int8_ops / PEAKS["int8"] + max(flops - int8_dense_ops, 0.0) / \
        precision_peak


def per_unit(calls, flops: float, scale: float, precision_peak: float
             ) -> dict:
    """`tally` of the reference's calls and its FlopCounterMode count,
    both taken on a part of a unit and scaled by `scale` to the whole
    unit, with the unit's least seconds (`step_least_s`)."""
    out = {k: v * scale for k, v in tally(calls).items()}
    out["flops"] = flops * scale
    out["step_least_s"] = step_least_s(out["flops"], out["int8_dense_ops"],
                                       out["int8_ops"], precision_peak)
    return out
