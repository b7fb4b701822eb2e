"""Kernel `conv2d_int8`'s contract on the card is lav_tpu's s8 conv's, on
the CPU.

`conv2d_int8_nhwc` takes every conv that lav_tpu's XLA s8 conv computes
and the port's `quantize_tree` can produce:
* a C that is not a multiple of 16 is padded with zero channels, in the
  activations and (once, kept on the weight tensor) in the OHWI weight; a
  zero channel adds 0 to each int32 sum.  The padded operands walked as
  the kernel walks its plan give the plain version's int32 sums, exactly,
  and the dequantized output equals the plain version's and lav_tpu's
  `conv2d_int8` (f32, exact);
* up to 16 taps per phase and axis and 16 phases per axis: a 9x9 direct
  conv and transposed convs with 9-16 taps per phase fit the kernel's
  tables, decode back from the ints handed to it, and their plans walk
  to the plain version's sums (and to lav_tpu's transposed conv);
* a conv beyond 16 raises with the documented message.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.nn import quant as JQ
from lav_tpu_torch.nn import quant as Q
from tests.test_torch_conv_plan import (
    SMS, _dequant, _plain_sums, _run_plan, assert_plan_ints_decode,
)


def test_c24_conv_padded_as_the_wrapper_pads_it_is_exact():
    k, s, p, C, O = 3, 1, 1, 24, 16
    r = np.random.default_rng(24)
    jp = JQ.quantize_conv({"w": jnp.asarray(r.normal(size=(k, k, C, O))
                                            .astype(np.float32)),
                           "b": jnp.asarray(r.normal(size=O)
                                            .astype(np.float32))})
    x = (r.normal(size=(2, 9, 10, C)) * 3).astype(np.float32)
    s_x = np.float32(np.abs(x).max() / 127.0 * 0.9)
    jp["x_scale"] = jnp.float32(s_x)
    ref = np.asarray(JQ.conv2d_int8(jp, jnp.asarray(x), (s, s),
                                    ((p, p), (p, p)), (1, 1)))
    w = torch.from_numpy(np.asarray(jp["w_int8"]).transpose(3, 0, 1, 2)
                         .copy())
    w_scale = torch.from_numpy(np.array(jp["w_scale"]))
    b = torch.from_numpy(np.array(jp["b"]))
    xq = Q.quantize_act(torch.from_numpy(x), torch.tensor(s_x))

    xp, wp = Q.pad_channels(xq), Q._kernel_weight(w)
    assert xp.shape[-1] == wp.shape[-1] == 32
    assert not xp[..., C:].any() and not wp[..., C:].any()
    assert torch.equal(xp[..., :C], xq) and torch.equal(wp[..., :C], w)
    # made once: the same padded tensor while the weight stays the same
    assert Q._kernel_weight(w) is wp
    pads = ((p, p), (p, p))
    plan = Q.conv_plan(*xp.shape, O, k, k, (s, s), pads, (1, 1), (1, 1))
    assert plan["axes"][0][0] == ref.shape[1]
    acc, _ = _run_plan(xp, wp, plan)
    assert torch.equal(acc.float(), _plain_sums(xq, w, (s, s), pads, (1, 1),
                                                (1, 1)))
    out = _dequant(acc, torch.tensor(s_x), w_scale, b, torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    plain = Q.conv2d_int8_nhwc(xq, w, w_scale, torch.tensor(s_x), b, (s, s),
                               pads, (1, 1), torch.float32)
    assert torch.equal(plain, out)
    # an in-place change of the weight makes a new padded copy
    w[0, 0, 0, 0] = -w[0, 0, 0, 0]
    assert Q._kernel_weight(w) is not wp
    assert torch.equal(Q._kernel_weight(w)[..., :C], w)
    # C a multiple of 16 is left as it is
    assert Q.pad_channels(xp) is xp and Q._kernel_weight(wp) is wp


def test_9x9_direct_conv_fits_the_widened_tables():
    r = np.random.default_rng(9)
    xq = torch.from_numpy(r.integers(-127, 128, size=(2, 13, 12, 16))
                          .astype(np.int8))
    w = torch.from_numpy(r.integers(-127, 128, size=(8, 9, 9, 16))
                         .astype(np.int8))
    args = (2, 13, 12, 16, 8, 9, 9, (1, 1), ((4, 4), (4, 4)), (1, 1),
            (1, 1))
    plan = assert_plan_ints_decode(args)
    assert [len(plan["axes"][a][3][0][1]) for a in (0, 1)] == [9, 9]
    acc, _ = _run_plan(xq, w, plan)
    assert torch.equal(acc.float(), _plain_sums(xq, w, (1, 1), args[8],
                                                (1, 1), (1, 1)))


# (ksize, stride, padding, output_padding, H): 9 to 16 taps per phase and
# axis, and 16 phases of one tap
WIDE_TRANSPOSED = [(18, 2, 4, 0, 4), (32, 2, 8, 1, 3), (16, 16, 0, 0, 2)]


@pytest.mark.parametrize("geom", WIDE_TRANSPOSED)
def test_wide_transposed_conv_fits_the_widened_tables(geom):
    k, s, p, op, H = geom
    C, O = 16, 8
    r = np.random.default_rng(k + s)
    x = (r.normal(size=(1, H, H + 1, C)) * 2).astype(np.float32)
    jp = JQ.quantize_conv({"w": jnp.asarray(r.normal(size=(k, k, C, O))
                                            .astype(np.float32))})
    s_x = np.float32(np.abs(x).max() / 127.0)
    jp["x_scale"] = jnp.float32(s_x)
    pads = ((k - 1 - p, k - 1 - p + op),) * 2
    ref = np.asarray(JQ.conv_transpose2d_int8(jp, jnp.asarray(x), pads,
                                              (s, s)))
    w = torch.from_numpy(np.flip(np.asarray(jp["w_int8"]), (0, 1))
                         .transpose(3, 0, 1, 2).copy())
    xq = Q.quantize_act(torch.from_numpy(x), torch.tensor(s_x))
    args = (*xq.shape, O, k, k, (1, 1), pads, (1, 1), (s, s))
    plan = assert_plan_ints_decode(args)
    (_, Py, _, ys), (_, Px, _, xs) = plan["axes"]
    assert Py == Px == s and max(len(t) for _, t in ys + xs) == k // s
    acc, _ = _run_plan(xq, w, plan)
    assert torch.equal(acc.float(), _plain_sums(xq, w, (1, 1), pads, (1, 1),
                                                (s, s)))
    out = _dequant(acc, torch.tensor(s_x), torch.from_numpy(
        np.array(jp["w_scale"])), None, torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_a_conv_beyond_16_taps_or_phases_still_raises():
    for args in ((1, 20, 20, 16, 8, 17, 3, (1, 1), ((8, 8), (1, 1)),
                  (1, 1), (1, 1)),
                 (1, 4, 4, 16, 8, 34, 34, (1, 1), ((16, 16), (16, 16)),
                  (1, 1), (2, 2))):
        with pytest.raises(ValueError, match="more than 16 taps per phase"):
            Q._plan_ints(*args, SMS)
    with pytest.raises(ValueError, match="1x17 phases"):
        Q._plan_ints(1, 4, 4, 16, 8, 1, 1, (1, 1), ((0, 0), (0, 0)),
                     (1, 1), (1, 17), SMS)
