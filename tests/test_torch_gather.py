"""lav_tpu_torch.ops.gather against the gather probe's Pallas kernel.

`take_along_rows` (kernel `take_along_rows`, whose plain version runs on
CPU tensors) against the kernel body of `scripts/exp_gather.py`
(`jnp.take_along_axis(x, idx, axis=0)` in a `pl.pallas_call`), rebuilt
here in interpret mode, and against `np.take_along_axis`: exact, a gather
moves values and computes nothing.  Out-of-range indices follow lav_tpu
(ROADMAP C11): -S <= idx < 0 wraps, anything else outside [0, S) gives
NaN, bit for bit the probe kernel's in f32 and bf16.

The CUDA kernel itself runs only on the card (chip_smoke.py phase
`gather`).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from lav_tpu_torch.ops.gather import take_along_rows, take_along_rows_plain
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _probe_kernel(x, idx):
    """exp_gather.py:28-39's kernel, in interpret mode."""
    def kern(x_ref, idx_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=0)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(idx.shape, x.dtype),
        interpret=True)(x, idx)


@pytest.mark.parametrize("S,L,dtype", [
    (8, 128, "float32"), (64, 128, "bfloat16"), (40, 256, "float32")])
def test_take_along_rows_matches_probe_kernel(S, L, dtype):
    r = np.random.default_rng(S + L)
    x = r.normal(size=(S, L)).astype(np.float32)
    idx = r.integers(0, S, size=(S, L)).astype(np.int32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(_probe_kernel(jx, jnp.asarray(idx)).astype(jnp.float32))
    xs = np.array(jx.astype(jnp.float32))
    np.testing.assert_array_equal(ref, np.take_along_axis(xs, idx, axis=0))
    tx = torch.from_numpy(xs).to(getattr(torch, dtype))
    out = take_along_rows(tx, torch.from_numpy(idx))
    assert out.dtype == tx.dtype and out.shape == (S, L)
    assert_close("ops.take_along_rows", out, ref, atol=0.0)


def test_take_along_rows_wrapper_routes_by_device():
    x = torch.randn(16, 8)
    idx = torch.randint(0, 16, (5, 8), dtype=torch.int32)
    assert torch.equal(take_along_rows(x, idx),
                       take_along_rows_plain(x, idx))
    with pytest.raises(ValueError):
        take_along_rows(x.to("meta"), idx.to("meta"))


def _bits(t):
    """A tensor's elements as integers of their width (NaN payloads kept)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad", [-1, -16, -17, 16, 1 << 20, -(1 << 20)])
def test_take_along_rows_out_of_range_matches_probe_kernel(bad, dtype):
    """lav_tpu's contract (ROADMAP C11): jnp.take_along_axis wraps an
    index in [-S, 0) to idx + S and fills NaN outside [-S, S), in f32 and
    bf16; take_along_rows on the CPU gives the interpret-mode probe
    kernel's bits, NaN positions and all (the kernel writes the same
    quiet NaN, chip_smoke.py phase `gather`)."""
    S, L = 16, 8
    r = np.random.default_rng(abs(bad) % 97)
    x = r.normal(size=(S, L)).astype(np.float32)
    idx = r.integers(-S, S, size=(5, L)).astype(np.int32)
    idx[2, 3] = bad
    idx[4, ::3] = bad
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = _probe_kernel(jx, jnp.asarray(idx))
    width = jnp.int32 if dtype == "float32" else jnp.int16
    ref_bits = np.asarray(jax.lax.bitcast_convert_type(ref, width))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = take_along_rows(tx, torch.from_numpy(idx))
    assert out.dtype == tx.dtype and out.shape == idx.shape
    nan = np.isnan(np.asarray(ref.astype(jnp.float32)))
    assert nan[2, 3] == (not -S <= bad < S) and nan.sum() >= (
        0 if -S <= bad < S else 4)
    np.testing.assert_array_equal(torch.isnan(out.float()).numpy(), nan)
    np.testing.assert_array_equal(_bits(out).numpy(), ref_bits)


def test_take_along_rows_plain_with_no_rows_gives_nan():
    x = torch.zeros((0, 8))
    out = take_along_rows_plain(x, torch.zeros((3, 8), dtype=torch.int32))
    assert out.shape == (3, 8) and torch.isnan(out).all()


# the probe's six cases (scripts/exp_gather.py:55-60)
PROBE_CASES = [(8, 128, "float32"), (512, 128, "float32"),
               (9216, 128, "float32"), (9216, 128, "bfloat16"),
               (9216, 256, "float32"), (25600, 128, "float32")]


@pytest.mark.parametrize("S,L,dtype", PROBE_CASES)
def test_take_along_rows_rows_in_order_give_x(S, L, dtype):
    """idx[i, l] = i gives x back bit for bit at the probe's shapes (the
    rows-in-order check of chip_smoke.py phase `gather`), and idx[i, l] =
    i - S, every index wrapped, gives the same."""
    x = torch.from_numpy(np.random.default_rng(S + L).normal(
        size=(S, L)).astype(np.float32)).to(getattr(torch, dtype))
    rows = torch.arange(S, dtype=torch.int32)[:, None].expand(S, L)
    for idx in (rows.contiguous(), (rows - S).contiguous()):
        out = take_along_rows(x, idx)
        assert out.dtype == x.dtype
        assert torch.equal(_bits(out), _bits(x))
