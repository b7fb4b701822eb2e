"""Each per-layer reader on a small recorded Chrome trace of known
numbers."""

import pytest

from lavbench import manifest, trace as TR

US = 1.0


def _trace():
    """Two ticks: a planner span launching a crop (30 us) and a library
    kernel (10 us), a lidar span launching an int8 conv (40 us), then a
    memset outside any span (5 us); the device idles 15 us between ticks
    while `aten::copy_` runs on the host."""
    ev, corr = [], [0]

    def op(name, ts, dur, cat="cpu_op"):
        ev.append(dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1,
                       tid=1))

    def launch(name, ts, dev_ts, dur, cat="kernel"):
        corr[0] += 1
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=ts, dur=1, pid=1, tid=1,
                       args=dict(correlation=corr[0])))
        ev.append(dict(ph="X", cat=cat, name=name, ts=dev_ts, dur=dur,
                       pid=0, tid=7, args=dict(correlation=corr[0])))

    for t0 in (0.0, 100.0):
        op("agent/planner", t0, 20, cat="user_annotation")
        launch("void crop_tiled<float>(Args)", t0 + 1, t0 + 2, 30)
        launch("void at::native::elementwise_kernel<128>", t0 + 5, t0 + 32,
               10)
        op("agent/lidar", t0 + 20, 20, cat="user_annotation")
        launch("conv2d_int8_bf16", t0 + 21, t0 + 42, 40)
        launch("Memset (Device)", t0 + 41, t0 + 82, 5, cat="gpu_memset")
        op("aten::copy_", t0 + 85, 15)
    return dict(traceEvents=ev)


@pytest.fixture
def summary(monkeypatch):
    monkeypatch.setattr(TR, "hand_sources", lambda: {
        "crop_tiled": "crop_shared", "conv2d_int8_bf16": "conv2d_int8"})
    return TR.summarize(_trace(), window_us=200.0, units=2)


def test_summary(summary):
    assert summary["busy_us"] == 2 * 85
    assert summary["idle_gaps"] == {"aten::copy_": 15.0}
    stages = {(d[0], d[3]) for d in summary["device"]}
    assert ("conv2d_int8_bf16", "agent/lidar") in stages
    assert ("void crop_tiled<float>(Args)", "agent/planner") in stages
    classes = {d[0]: d[1] for d in summary["device"]}
    assert classes["conv2d_int8_bf16"] == "hand_conv_int8"
    assert classes["void at::native::elementwise_kernel<128>"] == \
        "elementwise"
    b = TR.breakdown(summary)
    assert b["device_ops"][0] == ["conv2d_int8_bf16", 80e-6]
    assert b["idle_gaps"] == [["aten::copy_", 15e-6]]


LEAST = dict(conv2d_int8=20e-6, crop=15e-6, crop_bwd=1e-6,
             step_least_s=4e-6)
EXPECTED = {
    "launches_per_tick": 4.0,
    "stage_device_ms.planner": 0.040,
    "stage_device_ms.lidar": 0.040,
    "conv2d_int8_roofline": 50.0,
    "crop_shared_roofline.tick": 50.0,
    "crop_shared_bwd_roofline": None,
    "device_idle_pct.tick": 100.0 * (1 - 85e-6 / 200e-6),
    "device_idle_pct.train": 100.0 * (1 - 85e-6 / 200e-6),
    "mfu.tick": 2.0,
    "mfu.train": 2.0,
    "peak_mem_gib.train": 3.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(summary, metric):
    cell = manifest.Cell(manifest.load()["workloads"][0]["name"])
    ctx = dict(summary=summary, least=LEAST, unit_s=200e-6,
               memory_peak_bytes=3 * 2 ** 30)
    got = cell.reader(metric)(ctx)
    want = EXPECTED[metric]
    assert got == pytest.approx(want) if want is not None else got is None


def test_every_reader_is_tested():
    readers = {p.name[:-3] for p in (manifest.ROOT / "lavbench" / "metrics")
               .glob("*.py")}
    assert readers == set(EXPECTED)
    assert {m["name"] for m in manifest.load()["per_layer"]} <= readers
