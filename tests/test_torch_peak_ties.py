"""The two results of the port that differed from lav_tpu's, repaired, on
the CPU.

* The peak decode's tie order (`lav_tpu_torch/ops/peak.py`): a heatmap
  with 40 tied peaks and k = 15 decodes to lav_tpu's `extract_peaks`
  slot by slot (scores, columns, rows, valid), the lower index first, as
  `jax.lax.top_k` orders ties; and `det_inference` on tied ground-truth
  Gaussians (peaks of exactly 1.0 on pixel centres, more than max_det of
  them; the port's maps within 1e-7 of lav_tpu's, the peaks the same) to
  lav_tpu's on the same maps, every field slot by slot.
* The decoration sums (`scatter_add`, whose kernel now sums each pillar
  in point order): `scatter_add_plain` equals lav_tpu's XLA scatter-add
  (`zeros.at[pid].add`, the production route's decoration sums) bit for
  bit, on ids with duplicates, a dump row and ids out of range (dropped:
  lav_tpu's wrapper maps them to the dump row with a zero payload, which
  adds nothing), and its Pallas `scatter_pallas(op="add")` in interpret
  mode within the bound of a reordered sum (the kernel adds per-slab
  partial sums); and `scatter_add_layout` matches csrc/pillar_scatter.cu's
  `AddLayout`, read from the source.
"""

import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lav_tpu.ops import peak as JP
from lav_tpu.ops.pillar_pallas2 import scatter_pallas
from lav_tpu_torch.ops import peak as TP
from lav_tpu_torch.ops import pillar as P
from lav_tpu_torch.utils import native


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tied_heatmap(H=64, W=64, n=40, seed=0):
    """n isolated peaks of exactly 0.9 (more than 7 px apart, so max-pool
    NMS keeps each) over low noise."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.05, (H, W)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(4, H - 4, 8), np.arange(4, W - 4, 8),
                         indexing="ij")
    pick = rng.permutation(ys.size)[:n]
    hm[ys.ravel()[pick], xs.ravel()[pick]] = 0.9
    return hm


def test_tied_peaks_decode_in_lav_tpu_order():
    hm = _tied_heatmap()
    want = JP.extract_peaks(jnp.asarray(hm), max_det=15)
    got = TP.extract_peaks(torch.from_numpy(hm)[None], max_det=15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert (got[0][0] == 0.9).all()       # every slot a tie
    # the lower flat index first
    flat = (got[2][0] * 64 + got[1][0]).numpy()
    assert (np.diff(flat) > 0).all()


def test_det_inference_on_tied_gaussians_matches_lav_tpu():
    from lav_tpu.core.heatmap import detections_to_heatmap as j_d2h
    from lav_tpu_torch.core.heatmap import detections_to_heatmap as t_d2h

    rng = np.random.default_rng(3)
    n, H, W, ppm = 24, 96, 96, 4.0
    # on pixel centres: every Gaussian peaks at exactly 1.0
    locs = np.stack([rng.integers(-9, 9, n), rng.integers(-9, 9, n)],
                    -1).astype(np.float32) * 1.25
    oris = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    bbox = np.tile(np.float32([[0.9, 2.2]]), (n, 1))
    typs = np.ones((n,), np.int32)
    valid = np.ones((n,), bool)
    kw = dict(h=H, w=W, pixels_per_meter=ppm, min_x=-12.0, min_y=-12.0,
              max_y=12.0)
    jm = j_d2h(*(jnp.asarray(a) for a in (locs, oris, bbox, typs, valid)),
               **kw)
    tm = t_d2h(*(torch.from_numpy(a) for a in (locs, oris, bbox, typs,
                                               valid)), **kw)
    # the maps agree to an ulp of exp; the peaks are exactly 1.0 in both
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-7)
    assert ((tm[0][1] == 1.0) == torch.from_numpy(
        np.asarray(jm[0][1]) == 1.0)).all()
    assert (tm[0][1] == 1.0).sum() > 15   # more tied peaks than max_det
    # both decoders on lav_tpu's maps
    want = JP.det_inference(*jm, pixels_per_meter=ppm, max_det=15)
    got = TP.det_inference(*(torch.tensor(np.asarray(j))[None]
                             for j in jm), pixels_per_meter=ppm,
                           max_det=15)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _scatter_inputs(n=3000, S=257, C=4, seed=1):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, S // 4, n).astype(np.int32)     # duplicates
    pid[rng.uniform(size=n) < 0.2] = S - 1                # the dump row
    feat = rng.normal(size=(n, C)).astype(np.float32) * 10.0
    feat[pid == S - 1] = 0.0
    return feat, pid, S


def test_scatter_add_plain_is_lav_tpus_scatter_add():
    feat, pid, S = _scatter_inputs()
    got = P.scatter_add_plain(torch.from_numpy(feat), torch.from_numpy(pid),
                              S).numpy()
    xla = jnp.zeros((S, feat.shape[1])).at[pid].add(feat)
    np.testing.assert_array_equal(got, np.asarray(xla))
    # the Pallas kernel adds its slabs' partial sums: another order, held
    # to the bound of a reordered sum, 2 (n - 1) 2^-24 of the sum of |v|
    pallas = np.asarray(scatter_pallas(
        jnp.asarray(feat), jnp.asarray(pid), op="add", num_segments=S,
        slab=512, interpret=True))[:, :feat.shape[1]]
    mag = P.scatter_add_plain(torch.from_numpy(np.abs(feat)),
                              torch.from_numpy(pid), S).numpy()
    n = np.bincount(pid, minlength=S)[:, None]
    assert (np.abs(got - pallas) <= 2 * np.maximum(n - 1, 0) * 2.0 ** -24
            * mag).all()
    # ids out of range are dropped, as lav_tpu's dump row of zeros is
    bad = pid.copy()
    bad[:50] = -3
    bad[50:100] = S + 7
    kept = feat.copy()
    kept[:100] = 0.0
    np.testing.assert_array_equal(
        P.scatter_add_plain(torch.from_numpy(feat), torch.from_numpy(bad),
                            S).numpy(),
        np.asarray(jnp.zeros((S, 4)).at[np.where(bad < 0, S - 1, np.minimum(
            bad, S - 1))].add(kept)))


def _add_layout(n, rows):
    """csrc/pillar_scatter.cu's `AddLayout` constructor run in Python."""
    src = (native.CSRC_DIR / "pillar_scatter.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\w+);", src) if v.isdigit()}
    consts["kTileItems"] = consts["kThreads"] * consts["kItems"]
    scope = dict(consts, n=n, rows=rows, at=0)

    def take(nbytes):
        start = scope["at"]
        scope["at"] = -(-(start + nbytes) // consts["kAlign"]) * \
            consts["kAlign"]
        return start

    body = src[src.index("  AddLayout(long long n"):]
    body = body[body.index("{") + 1:body.index("\n  }")]
    scope["take"] = take
    code = re.sub(r"//[^\n]*", "", body)
    code = code.replace("int bits = 1;", "bits = 1;")
    code = code.replace(
        "while (bits < 62 && (1LL << bits) < rows) bits++;",
        "while bits < 62 and (1 << bits) < rows: bits += 1;")
    for stmt in code.split(";"):
        stmt = stmt.strip()
        if not stmt:
            continue
        stmt = re.sub(r"\((?:int|size_t)\)", "", stmt)
        stmt = re.sub(r"(\d+)ull", r"\1", stmt).replace("/", "//")
        exec(stmt, {}, scope)
    return scope, consts


@pytest.mark.parametrize("n,rows", [(960000, 16 * 102400 + 1), (1, 2),
                                    (3000, 257), (0, 10), (5000, 1 << 24)])
def test_scatter_add_layout_matches_the_kernel(n, rows):
    scope, consts = _add_layout(n, rows)
    assert (P.ADD_TILE, P.ADD_DIGITS, P.ADD_BITS, P.ADD_ALIGN) == (
        consts["kTileItems"], consts["kDigits"], consts["kBits"],
        consts["kAlign"])
    want = P.scatter_add_layout(n, rows)
    for key in ("keys0", "vals0", "keys1", "vals1", "hist", "totals",
                "total", "tiles", "passes"):
        assert want[key] == scope[key], key
