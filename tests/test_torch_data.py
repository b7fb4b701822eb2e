"""The port's data layer (lav_tpu_torch.data, utils/logging.py) against
lav_tpu's on the CPU, at tiny_config.

Both packages build their synthetic episodes from the same seeds; the
stores must hold the same bytes.  Every dataset name then runs over each
package's episodes, in memory (`DictStore`) and packed (`.lavpack`, the
port's packs through its own build of `native/lavstore.cpp`), and every
key of every sample must be equal in dtype, shape and value
(`np.array_equal`: the datasets are numpy on both sides, so nothing may
differ), over a few samples drawn in order from two dataset seeds.  The
loader's batches over two epochs must equal lav_tpu's
`DataLoader._host_batches`, with the dtypes lav_tpu's steps get from
`jax.device_put` (x64 off: float64 -> float32, int64 -> int32).  The
logger's records equal lav_tpu's.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu.data import datasets as JD
from lav_tpu.data import lavpack as JP
from lav_tpu.data import loader as JL
from lav_tpu.data import store as JS
from lav_tpu.utils.logging import Logger as JLogger
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.data import convert as TC
from lav_tpu_torch.data import datasets as TD
from lav_tpu_torch.data import lavpack as TP
from lav_tpu_torch.data import loader as TL
from lav_tpu_torch.data import store as TS
from lav_tpu_torch.utils.logging import Logger

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain for lavstore")

NAMES = ("bev", "temporal_bev", "seg", "bra", "lidar", "lidar_painted",
         "temporal_lidar_painted", "point_paint", "rgb")
TEMPORAL = ("temporal_bev", "temporal_lidar_painted")
EPISODE = dict(n_frames=9, n_actors=4, n_lidar=96, img_hw=(24, 32),
               bev_hw=(32, 32), with_painted=True, n_seg=4)
DATASET_SEEDS = (2021, 7)


def _cfgs(name):
    kw = dict(num_frame_stack=2) if name in TEMPORAL else {}
    return j_tiny_config(**kw), tiny_config(**kw)


def _episodes(S):
    return [S.make_synthetic_episode(seed=s, **EPISODE) for s in (0, 1)]


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Each package's episodes packed by its own lavpack writer."""
    root = tmp_path_factory.mktemp("packs")
    out = {}
    for tag, S, P in (("jax", JS, JP), ("torch", TS, TP)):
        paths = [P.convert_episode(ep, str(root / f"{tag}{i}.lavpack"))
                 for i, ep in enumerate(_episodes(S))]
        out[tag] = paths
    return out


def _assert_same_sample(tag, want, got):
    assert list(want) == list(got), tag
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f"{tag} {k}"
        assert np.array_equal(a, b), f"{tag} {k}"


def test_synthetic_episodes_hold_the_same_bytes():
    for j, t in zip(_episodes(JS), _episodes(TS)):
        assert j.store._d == t.store._d


@pytest.mark.parametrize("store", ["dict", "lavpack"])
@pytest.mark.parametrize("name", NAMES)
def test_dataset_samples_equal_lav_tpu(name, store, packs):
    jcfg, tcfg = _cfgs(name)
    if store == "dict":
        j_eps, t_eps = _episodes(JS), _episodes(TS)
    else:
        j_eps = [JS.open_episode(p) for p in packs["jax"]]
        t_eps = [TS.open_episode(p) for p in packs["torch"]]
        assert isinstance(t_eps[0].store, TP.LavPackStore)
    for seed in DATASET_SEEDS:
        jds = JD.get_dataset(name, jcfg, j_eps, seed=seed)
        tds = TD.get_dataset(name, tcfg, t_eps, seed=seed)
        assert len(jds) == len(tds) > 2
        # in order, with a repeat: the datasets' draws advance per sample
        for i in (0, len(tds) // 2, len(tds) - 1, 0):
            _assert_same_sample(f"{name}/{store}/{seed}[{i}]", jds[i],
                                tds[i])


def test_from_data_dir_reads_the_packs(packs, tmp_path):
    for i, p in enumerate(packs["torch"]):
        shutil.copy(p, tmp_path / f"ep{i}.lavpack")
    cfg = tiny_config(data_dir=str(tmp_path))
    ds = TD.get_dataset("lidar_painted", cfg)
    ref = TD.get_dataset("lidar_painted", cfg, _episodes(TS))
    assert len(ds) == len(ref)
    _assert_same_sample("data_dir", ref[1], ds[1])


@pytest.mark.parametrize("name", ["lidar_painted", "point_paint"])
def test_loader_matches_lav_tpu_over_two_epochs(name):
    """The port's batches (on the CPU) equal lav_tpu's host batches in
    value, and carry the dtypes of lav_tpu's device_put."""
    jcfg, tcfg = _cfgs(name)
    jds = JD.get_dataset(name, jcfg, _episodes(JS))
    tds = TD.get_dataset(name, tcfg, _episodes(TS))
    jl, tl = JL.DataLoader(jds, 3, seed=5), TL.DataLoader(tds, 3, seed=5)
    n = 0
    for epoch in range(2):
        for want, got in zip(jl._host_batches(), tl, strict=True):
            assert list(want) == list(got)
            for k, v in want.items():
                dev = jax.device_put(v)
                assert str(got[k].dtype).split(".")[1] == str(dev.dtype), k
                assert got[k].device.type == "cpu"
                assert np.array_equal(got[k].numpy(), np.asarray(dev)), k
            n += 1
    assert n == 2 * len(tl) > 2
    assert len(tl.wait_ms) == n
    # the narrowing is exercised: point_paint's idx is int64 on the host
    if name == "point_paint":
        assert want["idx"].dtype == np.int64 and got["idx"].dtype == \
            torch.int32


def test_loader_reports_producer_failures():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("bad sample")

    with pytest.raises(RuntimeError, match="producer") as e:
        list(TL.DataLoader(Broken(), 2))
    assert isinstance(e.value.__cause__, ValueError)


def test_lavpack_roundtrip_through_the_port_build(tmp_path):
    assert TP.build() == TP.LIB_PATH
    assert os.path.getsize(TP.LIB_PATH) > 0
    p = str(tmp_path / "t.lavpack")
    w = TP.LavPackWriter(p)
    rng = np.random.default_rng(0)
    payloads = {f"key_{i:03d}".encode(): rng.bytes(64 * i + 1)
                for i in range(20)}
    for k, v in payloads.items():
        w.put(k, v)
    w.finish()
    for S in (TP.LavPackStore(p), JP.LavPackStore(p)):
        for k, v in payloads.items():
            assert S.get(k) == v
        assert S.get(b"nope") is None
        assert sorted(S.keys()) == sorted(payloads)
        S.close()


def test_lmdb_gates(monkeypatch, tmp_path):
    monkeypatch.setattr(TS, "_HAVE_LMDB", False)
    with pytest.raises(RuntimeError, match="lmdb is not installed"):
        TS.LMDBStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="lmdb"):
        TS.open_episode(str(tmp_path))
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError):
        TC.convert_lmdb_dir(str(tmp_path), str(tmp_path / "x.lavpack"))


def test_logger_matches_lav_tpu(tmp_path):
    metrics = dict(loss=torch.tensor(0.25), grad_norm=torch.tensor(3.5),
                   hist=torch.arange(4.0))
    grads = {"a": {"w": np.ones((2, 3), np.float32)},
             "b": np.full((4,), 2.0, np.float32)}
    recs = []
    for L, tag, m, g in ((JLogger, "jax", {k: v.numpy() for k, v in
                                          metrics.items()}, grads),
                         (Logger, "torch", metrics,
                          {"a": {"w": torch.ones(2, 3)},
                           "b": torch.full((4,), 2.0)})):
        log = L("t", save_dir=str(tmp_path / tag))
        r1, r2 = log.log(7, m), log.log_gradients(8, g)
        log.close()
        lines = [json.loads(s) for s in
                 open(tmp_path / tag / "metrics.jsonl")]
        diag = dict(np.load(tmp_path / tag / "diag_00000007.npz"))
        for r in (r1, r2, *lines):
            r.pop("t")
        recs.append((r1, r2, lines, diag))
    (j1, j2, jl, jd), (t1, t2, tl, td) = recs
    assert (j1, j2, jl) == (t1, t2, tl)
    assert list(jd) == list(td) == ["hist"]
    assert np.array_equal(jd["hist"], td["hist"])
