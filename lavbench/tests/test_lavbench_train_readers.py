"""The distillation step's stage readers on a small recorded Chrome trace
of known numbers, launched from two threads as a step on a card is: the
forward and the optimizer from the caller's thread, the backward with its
recompute from autograd's device thread."""

import pytest

from lavbench import manifest, trace as TR

STEPS = 2
CALLER, AUTOGRAD = 1, 2
# us a step of each stage's kernels in `_trace`
FORWARD, RECOMPUTE, BACKWARD, OPTIMIZER, OUTSIDE = 70, 40, 55, 9, 1


def _trace():
    """Two steps, each: on the caller's thread `distill/forward/lidar`
    (a conv of 50 us) and `distill/forward/loss` (a kernel of 20 us); on
    autograd's `distill/backward` launching a dgrad (30 us), then its
    `distill/backward/recompute/planner` (a conv of 40 us), then a wgrad
    (25 us); back on the caller's `distill/optimizer` with its
    `/step` (an add of 9 us); last, outside any span, the loss's copy to
    the host (1 us)."""
    ev, corr = [], [0]

    def span(name, ts, dur, tid):
        ev.append(dict(ph="X", cat="user_annotation", name=name, ts=ts,
                       dur=dur, pid=1, tid=tid))

    def launch(name, ts, dev_ts, dur, tid, cat="kernel"):
        corr[0] += 1
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       ts=ts, dur=1, pid=1, tid=tid,
                       args=dict(correlation=corr[0])))
        ev.append(dict(ph="X", cat=cat, name=name, ts=dev_ts, dur=dur,
                       pid=0, tid=7, args=dict(correlation=corr[0])))

    for t0 in (0.0, 1000.0):
        span("distill/forward/lidar", t0, 10, CALLER)
        launch("sm80_xmma_fprop_implicit_gemm", t0 + 1, t0 + 5, 50, CALLER)
        span("distill/forward/loss", t0 + 10, 10, CALLER)
        launch("void at::native::elementwise_kernel<128>", t0 + 11, t0 + 55,
               20, CALLER)
        span("distill/backward", t0 + 30, 100, AUTOGRAD)
        launch("sm80_xmma_dgrad_implicit_gemm", t0 + 31, t0 + 75, 30,
               AUTOGRAD)
        span("distill/backward/recompute/planner", t0 + 40, 20, AUTOGRAD)
        launch("sm80_xmma_fprop_implicit_gemm", t0 + 41, t0 + 105, 40,
               AUTOGRAD)
        launch("sm80_xmma_wgrad_implicit_gemm", t0 + 70, t0 + 145, 25,
               AUTOGRAD)
        span("distill/optimizer", t0 + 140, 30, CALLER)
        span("distill/optimizer/step", t0 + 145, 20, CALLER)
        launch("void at::native::vectorized_elementwise_kernel<4, add>",
               t0 + 146, t0 + 170, 9, CALLER)
        launch("Memcpy DtoH (Device -> Pageable)", t0 + 175, t0 + 180, 1,
               CALLER, cat="gpu_memcpy")
    return dict(traceEvents=ev)


@pytest.fixture
def summary(monkeypatch):
    monkeypatch.setattr(TR, "hand_sources", lambda: {})
    return TR.summarize(_trace(), window_us=2000.0, units=STEPS,
                        prefix="distill/")


EXPECTED = {
    "stage_device_ms.forward": FORWARD / 1e3,
    "stage_device_ms.recompute": RECOMPUTE / 1e3,
    "stage_device_ms.backward": BACKWARD / 1e3,
    "stage_device_ms.optimizer": OPTIMIZER / 1e3,
    "launches_per_step": 7.0,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader(summary, metric):
    cell = manifest.Cell("distill.f32.b32")
    assert metric in {m["name"] for m in cell.per_layer()}
    got = cell.reader(metric)(dict(summary=summary))
    assert got == pytest.approx(EXPECTED[metric])


def test_stages_and_the_rest_add_up_to_the_device_time(summary):
    cell = manifest.Cell("distill.f32.b32")
    stages = sum(cell.reader(f"stage_device_ms.{s}")(dict(summary=summary))
                 for s in ("forward", "recompute", "backward", "optimizer"))
    outside = sum(d[-1] for d in summary["device"] if not d[3])
    assert outside == STEPS * OUTSIDE
    total = sum(d[-1] for d in summary["device"])
    assert stages * 1e3 * STEPS + outside == pytest.approx(total)


def test_a_step_without_spans_reads_nothing(summary):
    """The step as it ran before it carried spans: every kernel's stage
    is ''."""
    cell = manifest.Cell("distill.f32.b32")
    bare = dict(summary, device=[d[:3] + ("",) + d[4:]
                                 for d in summary["device"]])
    for metric in EXPECTED:
        assert cell.reader(metric)(dict(summary=bare)) is None, metric


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_tick_reads_nothing(monkeypatch, metric):
    """The agent tick's recorded trace has no `distill/` stage, so none of
    the step's readers reports on it."""
    from lavbench.tests import test_lavbench_readers as tick

    monkeypatch.setattr(TR, "hand_sources", lambda: {})
    summary = TR.summarize(tick._trace(), window_us=200.0, units=2)
    cell = manifest.Cell(manifest.load()["workloads"][0]["name"])
    assert cell.reader(metric)(dict(summary=summary)) is None
