"""lav_tpu_torch.ops.gather against the gather probe's Pallas kernel.

`take_along_rows` (kernel `take_along_rows`, whose plain version runs on
CPU tensors) against the kernel body of `scripts/exp_gather.py`
(`jnp.take_along_axis(x, idx, axis=0)` in a `pl.pallas_call`), rebuilt
here in interpret mode, and against `np.take_along_axis`: exact, a gather
moves values and computes nothing.  The CUDA kernel itself runs only on
the card (chip_smoke.py phase `gather`).
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


@pytest.mark.parametrize("bad", [16, -1, 1 << 20])
def test_take_along_rows_plain_refuses_out_of_range_bf16(bad):
    """The plain version's contract is idx in [0, S): on the CPU an index
    outside it raises, where the kernel writes 0 (the card's contract,
    checked by chip_smoke.py phase `gather`); in range, bf16 bits move
    unchanged."""
    x = torch.randn(16, 8).bfloat16()
    idx = torch.randint(0, 16, (5, 8), dtype=torch.int32)
    out = take_along_rows(x, idx)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), torch.from_numpy(
        np.take_along_axis(x.view(torch.int16).numpy(), idx.numpy(), 0)))
    idx[2, 3] = bad
    with pytest.raises((RuntimeError, IndexError)):
        take_along_rows(x, idx)
