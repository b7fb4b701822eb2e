"""The launch plan of kernel `conv2d_int8` (lav_tpu_torch/nn/quant.py
`conv_plan`, `conv_tiles`, `_plan_ints`), on the CPU.

The kernel cannot run here, but every number it takes besides the tensors
comes from these pure functions:
* the phase plan: each output phase an ordinary conv of the undilated
  input over the taps that land on real pixels.  Executed here as the
  kernel walks it (a gather per tap, zeros outside the image, outputs
  stored with the phase period), its int32 sums equal the plain version's
  over the dilated input, exactly, for lav_tpu's three upconvs, an odd
  transposed conv (k=3, s=2, output_padding 1), the s2d conv1's
  asymmetric padding and the direct convs' strides and dilations; its
  dequantized output equals lav_tpu's `conv_transpose2d_int8` (f32,
  exact) and the plain version's (bf16, equal);
* a transposed conv's phases walk each tap once (no inserted zero);
* the tile chooser on every int8 conv shape of `chip_smoke.py`: a tile the
  kernel has, within the shared memory a block can use, wgmma's N a
  multiple of 8 up to 256, 16 | C (a 16-byte chunk never crosses a tap),
  the phases and taps within the kernel's tables, and the card's 132 SMs
  filled where the shape allows;
* the 591 ints handed to the kernel decode back to the plan, and the
  plan's size and tables are the kernel source's;
* the tiles and their rings, `TILES`, are the kernel source's instances;
* `chip_smoke.py`'s plain count of the walked taps is the plan's.
"""

import pathlib
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from lav_tpu.nn import quant as JQ
from lav_tpu_torch.nn import quant as Q

SMS = 132
SMEM_PER_BLOCK = 232448   # 227 KB, the most a block can use on Hopper
TILES = Q.TILES
CU = (pathlib.Path(Q.__file__).parents[1] / "csrc" / "conv2d_int8.cu")


def _tile_smem(bm, bn):
    """The kernel's dynamic shared memory for tile (bm, bn): its ring of
    (bm + bn) rows of BK bytes a stage, plus 1 KB to align the ring."""
    return TILES[bm, bn] * (bm + bn) * Q.BK + 1024


def _run_plan(xq, w, plan):
    """int64 sums of the conv as the kernel walks `plan`: per phase (ry,
    rx), per tap pair, input rows j*s' + off (zero outside the image),
    into outputs (ry + P_y*j, rx + P_x*i)."""
    (OH, Py, sy, ys), (OW, Px, sx, xs) = plan["axes"]
    N, H, W, C = xq.shape
    x = xq.long()
    acc = torch.zeros((N, OH, OW, w.shape[0]), dtype=torch.int64)
    walked = 0
    for ry, (ny, ty) in enumerate(ys):
        for rx, (nx, tx) in enumerate(xs):
            part = torch.zeros((N, ny, nx, w.shape[0]), dtype=torch.int64)
            for ky, oy in ty:
                rows = torch.arange(ny) * sy + oy
                for kx, ox in tx:
                    cols = torch.arange(nx) * sx + ox
                    ok = (((rows >= 0) & (rows < H))[:, None]
                          & ((cols >= 0) & (cols < W))[None, :])
                    g = x[:, rows.clamp(0, H - 1)][:, :, cols.clamp(0, W - 1)]
                    g = g * ok[None, :, :, None]
                    part += torch.einsum("nhwc,oc->nhwo", g,
                                         w[:, ky, kx].long())
                    walked += N * ny * nx
            acc[:, ry::Py, rx::Px] = part
    return acc, walked


def _plain_sums(xq, w, stride, pads, dilation, lhs):
    """The plain version's int32 sums (unit scales, f32 output: exact for
    sums below 2^24)."""
    one = torch.ones(w.shape[0])
    return Q.conv2d_int8_plain(xq, w, one, torch.tensor(1.0), None, stride,
                               pads, dilation, torch.float32, lhs)


def _dequant(acc, s_x, w_scale, b, dtype):
    """The kernel's epilogue in the plain version's steps."""
    y = acc.float() * (s_x * w_scale)
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


# (ksize, stride, padding, output_padding, H): lav_tpu's three upconvs and
# an odd one
TRANSPOSED = [(1, 1, 0, 0, 7), (4, 2, 1, 0, 6), (4, 4, 1, 2, 3),
              (3, 2, 1, 1, 5)]


@pytest.mark.parametrize("geom", TRANSPOSED)
def test_transposed_phase_plan_matches_plain_and_lav_tpu(geom):
    k, s, p, op, H = geom
    C, O = 32, 24
    r = np.random.default_rng(40 + k * 10 + s)
    x = (r.normal(size=(2, H, H + 1, C)) * 2).astype(np.float32)
    wf = r.normal(size=(k, k, C, O)).astype(np.float32)
    jp = JQ.quantize_conv({"w": jnp.asarray(wf),
                           "b": jnp.asarray(r.normal(size=O)
                                            .astype(np.float32))})
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.9)
    jp["x_scale"] = jnp.float32(s_x)
    pads = ((k - 1 - p, k - 1 - p + op),) * 2
    ref = np.asarray(JQ.conv_transpose2d_int8(jp, jnp.asarray(x), pads,
                                              (s, s)))
    # the port's operands: lav_tpu's kernel flipped (as it is at apply
    # time), OHWI
    w = torch.from_numpy(np.flip(np.asarray(jp["w_int8"]), (0, 1))
                         .transpose(3, 0, 1, 2).copy())
    w_scale = torch.from_numpy(np.array(jp["w_scale"]))
    b = torch.from_numpy(np.array(jp["b"]))
    xq = Q.quantize_act(torch.from_numpy(x), torch.tensor(s_x))
    plan = Q.conv_plan(*xq.shape, O, k, k, (1, 1), pads, (1, 1), (s, s))
    assert (plan["axes"][0][0], plan["axes"][1][0]) == ref.shape[1:3]
    acc, walked = _run_plan(xq, w, plan)
    assert torch.equal(acc.float(),
                       _plain_sums(xq, w, (1, 1), pads, (1, 1), (s, s)))
    # each (output, tap) pair walked once per phase: k*k taps over s*s
    # phases of (OH/s)*(OW/s) outputs, no inserted zero
    OH, OW = plan["axes"][0][0], plan["axes"][1][0]
    assert walked * s * s == 2 * OH * OW * k * k
    out = _dequant(acc, torch.tensor(s_x), w_scale, b, torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    args = (xq, w, w_scale, torch.tensor(s_x), b, (1, 1), pads, (1, 1),
            torch.bfloat16, (s, s))
    assert torch.equal(_dequant(acc, torch.tensor(s_x), w_scale, b,
                                torch.bfloat16), Q.conv2d_int8_plain(*args))


# (ksize (h, w), stride, pads, dilation, input dilation): direct convs, the
# s2d conv1, and input dilation with stride
DIRECT = [((3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), (1, 1)),
          ((7, 7), (2, 2), ((3, 3), (3, 3)), (1, 1), (1, 1)),
          ((1, 1), (2, 2), ((0, 0), (0, 0)), (1, 1), (1, 1)),
          ((3, 3), (1, 1), ((2, 2), (2, 2)), (2, 2), (1, 1)),
          ((4, 4), (1, 1), ((2, 1), (2, 1)), (1, 1), (1, 1)),
          ((3, 4), (1, 2), ((0, 3), (1, 0)), (1, 1), (3, 2)),
          ((3, 3), (2, 3), ((1, 2), (2, 1)), (2, 1), (2, 3))]


@pytest.mark.parametrize("geom", DIRECT)
def test_phase_plan_matches_plain_sums(geom):
    (kh, kw), stride, pads, dil, lhs = geom
    r = np.random.default_rng(sum(kh * x for x in stride) + kw)
    xq = torch.from_numpy(r.integers(-127, 128, size=(2, 9, 11, 16))
                          .astype(np.int8))
    w = torch.from_numpy(r.integers(-127, 128, size=(8, kh, kw, 16))
                         .astype(np.int8))
    plan = Q.conv_plan(2, 9, 11, 16, 8, kh, kw, stride, pads, dil, lhs)
    acc, _ = _run_plan(xq, w, plan)
    ref = _plain_sums(xq, w, stride, pads, dil, lhs)
    assert acc.shape == ref.shape
    assert torch.equal(acc.float(), ref)
    if lhs == (1, 1):
        assert plan["axes"][0][1] == plan["axes"][1][1] == 1


def _all_shapes():
    """(name, conv_plan args) of every int8 conv shape chip_smoke.py
    drives: the production tick's and the variant routes'."""
    rows = []
    for name, N, H, W, C, O, k, st, pad, _ in chip_smoke._conv_int8_shapes():
        rows.append((name, (N, H, W, C, O, k, k, (st, st),
                            ((pad, pad), (pad, pad)), (1, 1), (1, 1))))
    for (name, N, H, W, C, O, k, pads, lhs, _,
         tconv) in chip_smoke._variant_conv_shapes():
        rows.append((name, (N, H, W, C, O, k, k, (1, 1), pads, (1, 1),
                            (lhs, lhs))))
    return rows


SHAPES = _all_shapes()


@pytest.mark.parametrize("name,args", SHAPES, ids=[n for n, _ in SHAPES])
def test_tiles_fit_the_kernel_on_every_path_shape(name, args):
    N, H, W, C, O = args[:5]
    plan = Q.conv_plan(*args, sms=SMS)
    bm, bn = plan["tile"]
    assert (bm, bn) in TILES
    assert bm % 64 == 0 and bn % 8 == 0 and bn <= 256
    assert _tile_smem(bm, bn) <= SMEM_PER_BLOCK
    assert TILES[bm, bn] >= 3   # a ring: one stage computed, one
    # retiring, at least one loading
    assert C % 16 == 0 and Q.BK % 16 == 0
    (OH, Py, _, ys), (OW, Px, _, xs) = plan["axes"]
    assert Py <= Q.MAX_PHASES and Px <= Q.MAX_PHASES
    assert all(len(t) <= Q.MAX_TAPS for _, t in ys + xs)
    m = N * max(n for n, _ in ys) * max(n for n, _ in xs)
    blocks = -(-m // bm) * -(-O // bn) * Py * Px
    smallest = -(-m // 128) * -(-O // 64) * Py * Px
    assert blocks >= SMS or (bm, bn) == (128, 64)
    assert blocks >= min(SMS, smallest)


def test_tiles_prefer_the_largest_that_fills_the_card():
    # planner conv1 (O = 64, 147 steps of K): BM 256
    assert Q.conv_tiles(256 * 48 * 48, 64, 1, 147) == (256, 64)
    # the lidar heads (O = 64, 27 steps): two 128 x 64 blocks an SM
    assert Q.conv_tiles(16 * 160 * 160, 64, 1, 27) == (128, 64)
    # planner layer4's 3x3 (M = 2304, O = 512): 72 blocks at 128x128
    assert Q.conv_tiles(2304, 512, 1, 36) == (128, 64)
    assert Q.conv_tiles(9216, 256, 1, 18) == (128, 128)
    # upconv3's 16 phases of 25600 outputs
    assert Q.conv_tiles(25600, 128, 16, 1) == (128, 128)
    assert Q.conv_tiles(10, 8, 1, 1) == (128, 64)
    # the shared memory of each tile's ring, as csrc/conv2d_int8.cu's
    assert [_tile_smem(*t) for t in TILES] == [205824, 197632, 99328]
    # two 128-row blocks share an SM's 228 KB
    assert 2 * (_tile_smem(128, 64) + 1024) <= 228 * 1024


def plan_ints_of_source():
    """(ints in `Plan`, kMaxP, kMaxT) as csrc/conv2d_int8.cu states them."""
    src = CU.read_text()
    size = re.search(r"sizeof\(Plan\) == (\d+) \* sizeof\(int\)", src)
    maxp = re.search(r"constexpr int kMaxP = (\d+);", src)
    maxt = re.search(r"constexpr int kMaxT = (\d+);", src)
    return int(size.group(1)), int(maxp.group(1)), int(maxt.group(1))


def assert_plan_ints_decode(args):
    """_plan_ints(args) decodes back to conv_plan(args): the header, then
    per axis n_out[P], ntaps[P] and tap[P][T], each tap its input offset *
    65536 + its kernel index; the length and the tables are the kernel
    source's."""
    N, H, W, C, O, KH, KW = args[:7]
    OH, OW, ints = Q._plan_ints(*args, SMS)
    ints = list(ints)
    size, maxp, maxt = plan_ints_of_source()
    P, T = Q.MAX_PHASES, Q.MAX_TAPS
    assert (P, T) == (maxp, maxt)
    assert len(ints) == size == 15 + 2 * (2 * P + P * T)
    plan = Q.conv_plan(*args, sms=SMS)
    (_, Py, sy, ys), (_, Px, sx, xs) = plan["axes"]
    assert ints[:15] == [N, H, W, C, O, KH, KW, OH, OW, Py, Px, sy, sx,
                         *plan["tile"]]
    for a, phases in enumerate((ys, xs)):
        base = 15 + a * (2 * P + P * T)
        n_out = ints[base:base + P]
        ntaps = ints[base + P:base + 2 * P]
        taps_at = ints[base + 2 * P:base + 2 * P + P * T]
        for r, (n, taps) in enumerate(phases):
            assert n_out[r] == n and ntaps[r] == len(taps)
            assert [(v & 0xFFFF, v >> 16) for v in
                    taps_at[r * T:r * T + len(taps)]] == list(taps)
        assert all(v == 0 for v in n_out[len(phases):])
    return plan


@pytest.mark.parametrize("name,args", SHAPES[-4:],
                         ids=[n for n, _ in SHAPES[-4:]])
def test_plan_ints_decode_to_the_plan(name, args):
    assert_plan_ints_decode(args)


def test_plan_refuses_what_the_kernel_tables_cannot_hold():
    with pytest.raises(ValueError, match="more than 16 taps"):
        Q._plan_ints(1, 20, 20, 16, 8, 17, 17, (1, 1), ((8, 8), (8, 8)),
                     (1, 1), (1, 1), SMS)
    with pytest.raises(ValueError, match="17x17 phases"):
        Q._plan_ints(1, 4, 4, 16, 8, 1, 1, (1, 1), ((0, 0), (0, 0)),
                     (1, 1), (17, 17), SMS)
    # stride 2 over input dilation 4: 2 phases of stride 1
    assert Q.axis_plan(5, 3, 2, (1, 1), 1, 4)[1:3] == (2, 1)


def test_tiles_are_the_kernel_sources_instances():
    src = CU.read_text()
    stages = {(int(bm), int(bn)): int(k) for bm, bn, k in re.findall(
        r"struct Stages<(\d+), (\d+)> \{ static constexpr int k = (\d+);",
        src)}
    assert stages == TILES
    launched = {(int(bm), int(bn)) for bm, bn in re.findall(
        r"p\.bm == (\d+) && p\.bn == (\d+)", src)}
    assert launched == set(TILES)


@pytest.mark.parametrize("name,args", SHAPES, ids=[n for n, _ in SHAPES])
def test_chip_smoke_counts_the_taps_the_plan_walks(name, args):
    N, H, W, C, O, KH, KW, stride, pads, dil, lhs = args
    plan = Q.conv_plan(*args, sms=SMS)
    for n, k, s, p, l, axis in zip((H, W), (KH, KW), stride, pads, lhs,
                                   plan["axes"]):
        assert chip_smoke._taps_walked(n, k, s, p, l) == sum(
            ny * len(taps) for ny, taps in axis[3])
