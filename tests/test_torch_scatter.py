"""The production pillar route's scatters (kernels `scatter_max` and
`scatter_add`, csrc/pillar_scatter.cu) against lav_tpu's Pallas
`scatter_pallas` (ops/pillar_pallas2.py) in interpret mode, on the CPU,
where the wrappers run their plain versions.

P = 1024 points into S = 301 segments, many duplicate ids, empty
segments and invalid points at the dump slot with zero payload (the
contract of `scatter_pallas`), in both of its modes.  max is exact (it
does not depend on order); add holds to atol 1e-5 with rtol 1e-6 (f32
sums of up to ~15 values of |v| <= 40 taken in another order: an ulp of
a sum near 200 is 1.5e-5), and its count lane is exact.  lav_tpu pads
its output to 128
lanes; those past C must be zero.  The CUDA kernels run only on the card
(chip_smoke.py, phase `scatter`).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.ops.pillar_pallas2 import scatter_pallas
from lav_tpu_torch.ops import pillar as P
from tests.torch_parity import assert_close

N_POINTS, SEGMENTS = 1024, 301


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(seed, C, op):
    r = np.random.default_rng(seed)
    pid = r.integers(0, SEGMENTS // 3, size=N_POINTS).astype(np.int32)
    invalid = r.uniform(size=N_POINTS) < 0.2
    pid[invalid] = SEGMENTS - 1
    if op == "max":   # post-ReLU payload in bf16, zeros and ties included
        feat = np.maximum(r.normal(size=(N_POINTS, C)), 0.0)
        feat = np.array(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32))
    else:             # decoration sums: xyz and a count lane
        feat = np.concatenate([r.uniform(-20, 40, (N_POINTS, C - 1)),
                               np.ones((N_POINTS, 1))], axis=1)
    feat[invalid] = 0.0
    return feat.astype(np.float32), pid


@pytest.mark.parametrize("mode", ["stream", "rmw"])
def test_scatter_max_matches_pallas(mode):
    feat, pid = _case(0, 64, "max")
    ref = scatter_pallas(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(pid),
                         op="max", num_segments=SEGMENTS, mode=mode,
                         interpret=True)
    out = P.scatter_max(torch.from_numpy(feat).bfloat16(),
                        torch.from_numpy(pid), SEGMENTS)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and out.shape == (SEGMENTS, 64)
    assert (ref[:, 64:] == 0).all()
    assert_close("scatter.max", out, ref[:, :64], atol=0.0)
    assert (out == 0).all(dim=1).float().mean() > 0.5   # empty segments


@pytest.mark.parametrize("mode", ["stream", "rmw"])
def test_scatter_add_matches_pallas(mode):
    feat, pid = _case(1, 4, "add")
    ref = scatter_pallas(jnp.asarray(feat), jnp.asarray(pid), op="add",
                         num_segments=SEGMENTS, mode=mode, interpret=True)
    out = P.scatter_add(torch.from_numpy(feat), torch.from_numpy(pid),
                        SEGMENTS)
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == (SEGMENTS, 4)
    assert (ref[:, 4:] == 0).all()
    assert_close("scatter.add", out, ref[:, :4], atol=1e-5, rtol=1e-6)
    assert_close("scatter.add.count", out[:, 3], ref[:, 3], atol=0.0)


def test_scatter_wrappers_route_by_device_and_drop_outside_ids():
    feat, pid = _case(2, 8, "max")
    f, p = torch.from_numpy(feat), torch.from_numpy(pid)
    p[:5] = SEGMENTS + 7          # outside the canvas: dropped
    p[5:9] = -1
    keep = (p >= 0) & (p < SEGMENTS)
    for op, plain in (("max", P.scatter_max_plain),
                      ("add", P.scatter_add_plain)):
        kernel = getattr(P, f"scatter_{op}")
        assert torch.equal(kernel(f, p, SEGMENTS), plain(f, p, SEGMENTS))
        assert torch.equal(plain(f, p, SEGMENTS),
                           plain(f[keep], p[keep], SEGMENTS))
        with pytest.raises(ValueError):
            kernel(f.to("meta"), p.to("meta"), SEGMENTS)
