"""The op, byte and FLOP counts at tiny shapes, against brute force."""

import itertools

import pytest
import torch

from lavbench import counts
from lavbench.ref import record
from lavbench.ref.nn import quant as RQ


def _real_taps(n, k, stride, pads, dil, lhs):
    """Brute force: dilate the input, pad it, and count the taps that land
    on an input pixel."""
    size = (n - 1) * lhs + 1
    real = [False] * (pads[0] + size + pads[1])
    for i in range(n):
        real[pads[0] + i * lhs] = True
    n_out = (len(real) - dil * (k - 1) - 1) // stride + 1
    return n_out, sum(real[o * stride + t * dil]
                      for o in range(n_out) for t in range(k))


@pytest.mark.parametrize("n,k,stride,pads,dil,lhs", [
    (7, 3, 1, (1, 1), 1, 1), (8, 3, 2, (1, 1), 1, 1), (9, 7, 2, (3, 3), 1, 1),
    (5, 4, 1, (2, 3), 1, 2), (6, 3, 1, (2, 2), 2, 1), (4, 1, 1, (0, 0), 1, 1)])
def test_taps(n, k, stride, pads, dil, lhs):
    assert counts._taps(n, k, stride, pads, dil, lhs) == \
        _real_taps(n, k, stride, pads, dil, lhs)


def test_conv2d_int8_counts_match_the_reference_call():
    x = torch.randint(-5, 5, (2, 6, 5, 16), dtype=torch.int8)
    w = torch.randint(-5, 5, (8, 3, 3, 16), dtype=torch.int8)
    record.CALLS = []
    try:
        y = RQ.conv2d_int8_nhwc(x, w, torch.ones(8), torch.tensor(1.0),
                                torch.zeros(8), (1, 1), (1, 1), (1, 1),
                                torch.bfloat16)
        (kind, info), = record.CALLS
    finally:
        record.CALLS = None
    ops, nbytes, dense = counts.conv2d_int8(info)
    assert kind == "conv2d_int8" and y.shape == (2, 6, 5, 8)
    # taps on real pixels: rows 6 outputs x (2 + 3*4 + 2), cols likewise
    real_h, real_w = 2 + 3 * 4 + 2, 2 + 3 * 3 + 2
    assert ops == 2 * 2 * 8 * 16 * real_h * real_w
    assert dense == 2 * 2 * 6 * 5 * 8 * 9 * 16
    assert nbytes == (2 * 6 * 5 * 16 + 8 * 9 * 16 + 8 * 4 + 4 + 8 * 4
                      + 2 * 6 * 5 * 8 * 2)


def test_crop_counts():
    src = torch.zeros(1, 8, 8, 4)
    # one 2x2 crop whose four taps sit at the corners of pixel (1, 1)
    g = torch.full((1, 1, 2, 2, 2), -1.0 + 2.0 / 7.0 * 1.25)
    info = dict(src=src, grid=g, q8=False, grad=True)
    assert counts.crop_pixels(src, g) == 4
    ops, nbytes = counts.crop(info)
    assert ops == 8 * 4 * 4
    assert nbytes == 4 * 4 * 4 + g.numel() * 4 + 4 * 4 * 4
    ops, nbytes = counts.crop_bwd(info)
    assert nbytes == 4 * 4 * 4 + g.numel() * 4 + src.numel() * 4
    info["q8"] = True
    assert counts.crop(info)[1] == 4 * 4 * 4 + g.numel() * 4 + 4 * 4


def test_tally_and_step_least():
    calls = [("conv2d_int8", dict(x=(1, 4, 4, 16), w=(16, 1, 1, 16),
                                  stride=(1, 1), padding=((0, 0), (0, 0)),
                                  dilation=(1, 1), lhs=(1, 1), bias=False,
                                  out_elem=2))]
    t = counts.tally(calls)
    ops = 2 * 16 * 16 * 16
    nbytes = 256 + 256 + 64 + 4 + 16 * 16 * 2
    assert t["int8_ops"] == ops == t["int8_dense_ops"]
    assert t["conv2d_int8"] == pytest.approx(
        max(nbytes / counts.HBM_BYTES_PER_S, ops / counts.PEAKS["int8"]))
    least = counts.step_least_s(1e9 + ops, ops, ops, counts.PEAKS["bfloat16"])
    assert least == pytest.approx(ops / 1979e12 + 1e9 / 989e12)


def test_flop_count_of_a_reference_conv():
    from torch.utils.flop_counter import FlopCounterMode

    from lavbench.ref.nn.layers import Conv2d

    conv = Conv2d(16, 8, 3, 1, 1, gen=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        conv(torch.zeros(2, 16, 6, 5))
    assert fc.get_total_flops() == 2 * 2 * 6 * 5 * 8 * 16 * 9


def test_peaks_are_the_data_sheet():
    assert counts.PEAKS == {"int8": 1979e12, "bfloat16": 989e12,
                            "tf32": 495e12, "float32": 67e12}
    assert counts.HBM_BYTES_PER_S == 3.35e12
    assert list(itertools.islice(counts.PEAKS, 1)) == ["int8"]
