"""The `torch.profiler` labels of the port's distillation step
(lav_tpu_torch.train.distill, utils/profiling.py::backward_span,
utils/tree.py::checkpoint), on the CPU at tiny_config.

* One remat step at B = 32 in f32 (where the planner's scoped checkpoint
  over the student crops runs too) under the profiler records
  `distill/forward/lidar`, `/planner`, `/loss` in that order,
  `distill/backward` after them with remat's recomputes (`/lidar`,
  `/planner`, `/crops`) inside it, and `distill/optimizer` after it.
* The same step from the same weights, batch and noise without the
  profiler gives the same loss terms, `grad_norm`, parameters, Adam
  state and BN statistics, bit for bit.
* Without a profiler the step backpropagates from the loss's own
  `grad_fn`; under one, from a single identity node in front of it.
* The BEV trainer's step labels its tail `privileged/` and opens no
  `distill/` range.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.models.planner import draw_noise
from lav_tpu_torch.train import distill as TD
from lav_tpu_torch.train import privileged as TP

B, POINTS = 32, 64
FORWARD = ("distill/forward/lidar", "distill/forward/planner",
           "distill/forward/loss")
RECOMPUTE = ("distill/backward/recompute/lidar",
             "distill/backward/recompute/planner",
             "distill/backward/recompute/crops")


def _ranges(prof, prefix):
    """[(name, start, end)] of the labels starting with `prefix`, by
    start."""
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith(prefix))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def steps():
    """One remat step from the same weights, batch and noise with the
    profiler and without: ((metrics, models, optimizer), ...), the
    profile."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tiny_config()
        models = TD.distill_models(cfg, torch.Generator().manual_seed(3))
        batch = TD.make_batch(cfg, B, POINTS, seed=3, device="cpu")
        noise = draw_noise(torch.Generator().manual_seed(4), B,
                           cfg.max_objs - 1, cfg.max_num_cars_student)
        step = TD.make_full_train_step(cfg, v2=True, remat=True)
        runs = []
        for traced in (True, False):
            m = copy.deepcopy(models)
            opt = TD.adam(m)
            if traced:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    metrics = step(m, opt, batch, noise=noise)
            else:
                metrics = step(m, opt, batch, noise=noise)
            runs.append((metrics, m, opt))
    finally:
        torch.set_num_threads(threads)
    return runs, prof


def test_step_records_its_spans_nested(steps):
    _, prof = steps
    spans = _ranges(prof, "distill/")
    names = [s[0] for s in spans]
    assert sorted(names) == sorted(FORWARD + ("distill/backward",)
                                   + RECOMPUTE + ("distill/optimizer",))
    by = {s[0]: s for s in spans}
    forward = [by[n] for n in FORWARD]
    assert [s[0] for s in sorted(forward, key=lambda s: s[1])] == \
        list(FORWARD)
    for a, b in zip(forward, forward[1:]):
        assert a[2] <= b[1]
    backward, optimizer = by["distill/backward"], by["distill/optimizer"]
    assert forward[-1][2] <= backward[1] and backward[2] <= optimizer[1]
    for n in RECOMPUTE:
        assert _inside(by[n], backward), n


def test_profiler_changes_no_number(steps):
    (m1, traced, opt1), (m0, plain, opt0) = steps[0]
    assert m1.keys() == m0.keys()
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k
    for (name, a), b in zip(traced.state_dict().items(),
                            plain.state_dict().values()):
        assert torch.equal(a, b), name
    for p1, p0 in zip(traced.parameters(), plain.parameters()):
        s1, s0 = opt1.state.get(p1, {}), opt0.state.get(p0, {})
        assert s1.keys() == s0.keys()
        assert all(torch.equal(s1[k], s0[k]) for k in s0)


def test_backward_adds_a_node_only_under_a_profiler(monkeypatch):
    seen, real = [], TD.backward_span

    def spy(loss, name):
        out = real(loss, name)
        seen.append((loss, out, name))
        return out

    monkeypatch.setattr(TD, "backward_span", spy)
    step, models, opt, batch, gen, _ = TD.distill_setup(
        2, POINTS, device="cpu", cfg=tiny_config())
    step(models, opt, batch, gen=gen)
    with profile(activities=[ProfilerActivity.CPU]):
        step(models, opt, batch, gen=gen)
    (plain, plain_out, n0), (loss, out, n1) = seen
    assert n0 == n1 == "distill/backward"
    assert plain_out is plain
    assert out is not loss and torch.equal(out, loss)
    assert out.grad_fn.next_functions == ((loss.grad_fn, 0),)


def test_privileged_step_records_no_distill_range():
    step, models, opt, batch, gen, _ = TP.bev_setup(
        2, device="cpu", cfg=tiny_config())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(models, opt, batch, gen)
    assert not _ranges(prof, "distill/")
    names = {s[0] for s in _ranges(prof, "privileged/")}
    assert {"privileged/backward", "privileged/optimizer"} <= names
