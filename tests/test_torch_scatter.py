"""The production pillar route's scatters (kernels `scatter_max` and
`scatter_add`, csrc/pillar_scatter.cu) against lav_tpu's Pallas
`scatter_pallas` (ops/pillar_pallas2.py) in interpret mode, on the CPU,
where the wrappers run their plain versions.

P = 1024 points into S = 301 segments, many duplicate ids, empty
segments and invalid points at the dump slot with zero payload (the
contract of `scatter_pallas`), in both of its modes.  The plain max is
also held to lav_tpu's production route for the canvas, the XLA scatter
`jnp.zeros(...).at[pid].max(feat, mode="drop")`, on NaN, -0.0 and negative
payloads and on ids outside the canvas, exactly and with NaN positions
equal: a NaN lands and sticks, -0.0 and negative values leave +0.  max is exact (it
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


def _agent_case(seed):
    """Ids and payloads shaped like the agent's decoration sums: most
    points at the dump slot with a zero payload (as in the agent's first
    ticks, while its ring buffer fills), a few hot pillars of 100+ points
    each, the rest spread over the canvas; xyz in the sensor's range and a
    count lane."""
    r = np.random.default_rng(seed)
    n_dump, hot, n_hot, n_spread = 2400, (7, 150, 222), 120, 600
    pid = np.concatenate([
        np.full(n_dump, SEGMENTS - 1),
        np.repeat(hot, n_hot),
        r.integers(0, SEGMENTS - 1, n_spread)]).astype(np.int32)
    n = pid.size
    feat = np.concatenate([r.uniform(-20, 40, (n, 3)), np.ones((n, 1))],
                          axis=1).astype(np.float32)
    feat[:n_dump] = 0.0
    order = r.permutation(n)               # the dump and hot points mixed
    return feat[order], pid[order]


def _assert_sums_close(name, out, ref, feat, pid):
    """Each xyz lane within max(1e-6, 2(n-1) 2^-24) of the pillar's sum of
    magnitudes, n its point count (two summation orders of n terms differ
    by at most 2(n-1) units of rounding of that sum; the bound chip_smoke.py
    holds the kernel to); the count lane exact."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    mag = np.zeros_like(ref)
    np.add.at(mag, pid, np.abs(feat.astype(np.float64)))
    count = np.bincount(pid, minlength=ref.shape[0])[:, None]
    rtol = np.maximum(1e-6, 2 * np.maximum(count - 1, 0) * 2.0 ** -24)
    excess = np.abs(out[:, :3] - ref[:, :3]) - rtol * mag[:, :3]
    assert excess.max() <= 0, (name, excess.max())
    assert_close(name, out[:, :3], ref[:, :3], atol=float(
        (rtol * mag[:, :3]).max()))
    assert_close(f"{name}.count", out[:, 3], ref[:, 3], atol=0.0)


@pytest.mark.parametrize("mode", ["stream", "rmw"])
def test_scatter_add_matches_pallas_at_agent_distribution(mode):
    feat, pid = _agent_case(3)
    ref = scatter_pallas(jnp.asarray(feat), jnp.asarray(pid), op="add",
                         num_segments=SEGMENTS, mode=mode, interpret=True)
    out = P.scatter_add(torch.from_numpy(feat), torch.from_numpy(pid),
                        SEGMENTS)
    ref = np.asarray(ref)
    assert (ref[:, 4:] == 0).all()
    assert int(ref[:, 3].max()) >= 120 and ref[SEGMENTS - 1, 3] == 0
    _assert_sums_close("scatter.add.agent", out, ref[:, :4], feat, pid)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_scatter_add_all_zero_rows_can_be_dropped_bit_for_bit():
    """Kernel `scatter_add` skips rows whose lanes are all +-0: the plain
    sums with those rows dropped equal the sums with them, bit for bit,
    with -0.0 payloads, a pillar whose sum cancels to 0, a NaN row that
    must still land and an infinite one."""
    feat, pid = _agent_case(4)
    pid[np.isin(pid, [9, 11])] = 12                   # 9, 11 kept apart
    feat[:40] = -0.0                                  # all -0 rows
    feat[40:80, :2] = -0.0                            # mixed +0 / -0 rows
    feat[40:80, 2:] = 0.0
    pid[:20] = 9                                      # a pillar of -0 only
    feat[80], feat[81] = [3.0, -2.5, 1.0, 1.0], [-3.0, 2.5, -1.0, 1.0]
    feat[82] = [-0.0, -0.0, -0.0, -0.0]
    pid[80:83] = 11                                   # x + (-x), then -0
    feat[83, 1] = np.nan                              # lands
    feat[84, 2] = np.inf
    f, p = torch.from_numpy(feat), torch.from_numpy(pid)
    nonzero = (f != 0).any(dim=1)
    assert (~nonzero).sum() > 2400
    full = P.scatter_add_plain(f, p, SEGMENTS)
    dropped = P.scatter_add_plain(f[nonzero], p[nonzero], SEGMENTS)
    assert torch.equal(_bits(full), _bits(dropped))
    assert torch.isnan(full[pid[83], 1]) and torch.isinf(full[pid[84], 2])
    assert _bits(full[9]).eq(0).all()                 # +0, never -0
    assert _bits(full[11, :3]).eq(0).all() and full[11, 3] == 2.0
    # the same in any order of the points
    perm = torch.from_numpy(np.random.default_rng(5).permutation(len(p)))
    shuffled = P.scatter_add_plain(f[perm], p[perm], SEGMENTS)
    keep = nonzero[perm]
    assert torch.equal(_bits(shuffled), _bits(P.scatter_add_plain(
        f[perm][keep], p[perm][keep], SEGMENTS)))


def _drop_case(seed, kind, n=256, S=40, C=8):
    """Payloads and ids for the drop scatter: normal values, then NaN
    lanes, -0.0 for every negative, only negative values, or a third of
    the ids at or past S (lav_tpu's route gives its invalid points the id
    S; JAX would wrap a negative id as Python indexing does, which the
    route never makes, and the port drops it:
    test_scatter_wrappers_route_by_device_and_drop_outside_ids)."""
    r = np.random.default_rng(seed)
    feat = r.normal(size=(n, C)).astype(np.float32)
    pid = r.integers(0, S, n).astype(np.int32)
    if kind == "nan":
        feat[r.uniform(size=(n, C)) < 0.02] = np.nan
    elif kind == "-0.0":
        feat[feat < 0] = -0.0
    elif kind == "negative":
        feat = -np.abs(feat) - 0.1
    elif kind == "outside":
        pid[::3] = S + r.integers(0, 50, pid[::3].size)
    return feat, pid, S


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["nan", "-0.0", "negative", "outside"])
def test_scatter_max_plain_matches_the_drop_scatter(kind, dtype):
    feat, pid, S = _drop_case(10, kind)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fj = jnp.asarray(feat, jdt)
    ref = jnp.zeros((S, feat.shape[1]), jdt).at[jnp.asarray(pid)].max(
        fj, mode="drop")
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    tf = torch.from_numpy(np.array(fj.astype(jnp.float32))).to(tdt)
    out = P.scatter_max(tf, torch.from_numpy(pid), S)
    assert out.dtype == tdt and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=0,
                               equal_nan=True)
    if kind == "nan":
        assert torch.isnan(out).any()
    else:   # -0.0 and negative values leave +0, as the drop scatter does
        assert torch.equal(torch.signbit(out.float()), torch.signbit(ref))
        assert (out >= 0).all()
