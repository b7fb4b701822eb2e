"""The v2 distillation step, closed loop: one optimizer step after the
other on a pool of distinct seeded batches, cycled.

Set-up builds the port's step as `train/distill.py::distill_setup` builds
it (`distill_models`, `adam`, `make_full_train_step`), with the
benchmark's weights loaded into the models, and drives it through its
first three steps, on batches 0, 1, 2 of the pool and noise drawn from the
seed, through the window's own call: they build and warm up every kernel
and give the readings that the check compares.  The window then takes
the same object on.

Correctness: after the window the reference (`ref/`, the same step in
plain PyTorch, in the configuration's precision) runs the first three
steps from the same weights on the same batches and noise.  Compared:
the first step's loss (the later steps' losses drift apart as training
amplifies the order of reductions, and are only read); the norm of the first gradient as Adam got it, worked
out from its first moment after one step, leaf by leaf; and the norm of
each leaf's change over the three steps.  A leaf's gap is taken against
the larger of its own reference norm and the median leaf's; leaves whose
reference gradient is under a thousandth of the median leaf's (moved by
round-off alone under Adam) are left out of the change.  For the
readings of the limits, `witness` runs the reference a second time and
compares it with its first run, as the program is compared, and names
the leaves behind the largest gaps.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from lavbench import counts, traffic as T
from lavbench.loops.common import DTYPES, Phases, model_fields, tf32
from lavbench.ref import record
from lavbench.ref.config import LAVConfig as RefConfig
from lavbench.ref.train import distill as RD
from lavbench.weights import Draw

BETA1 = 0.9
FIRST = 3        # steps the check compares
COUNT_ROWS = 2   # rows of the reference step whose work is counted


class Distill:
    unit = "step"
    prefix = "distill/"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from lav_tpu_torch.config import LAVConfig
        from lav_tpu_torch.train.distill import (
            adam, distill_models, make_full_train_step,
        )
        from lav_tpu_torch.utils import native

        self.config, self.traffic = config, traffic
        self.dev = torch.device(device)
        self.phases = phases = Phases(device)
        prec = config["precision"]
        self.cdt = DTYPES[prec["compute_dtype"]]
        tf32(prec["tf32"])
        if self.dev.type == "cuda":
            native.build_all()
        phases("kernels")
        fields = model_fields(config)
        self.cfg, self.ref_cfg = LAVConfig(**fields), RefConfig(**fields)
        self.B, self.lr = traffic["batch_size"], traffic["lr"]
        self.remat = traffic["remat"]
        self.ref_models = Draw.make(
            lambda d: RD.distill_models(self.ref_cfg, gen=d), seed, self.dev)
        with torch.device(self.dev):
            models = distill_models(self.cfg)
        models.load_state_dict(self.ref_models.state_dict())
        self.models = models
        self.opt = adam(models, self.lr)
        phases("weights")
        self.step = make_full_train_step(self.cfg, v2=True, mode="full",
                                         compute_dtype=self.cdt,
                                         remat=self.remat)
        self.pool = T.batch_pool(traffic, self.ref_cfg, seed, self.dev)
        self.gen = torch.Generator().manual_seed(seed + 1)
        self.noises = [self._noise() for _ in range(FIRST)]
        phases("traffic")
        self.losses = []
        for k in range(FIRST):
            m = self.step(self.models, self.opt, self.pool[k],
                          noise=self.noises[k])
            self.losses.append(float(m["loss"]))
            if k == 0:
                self.grads = first_grads(self.models, self.opt)
        self.change = changes(self.models, self.ref_models)
        phases("first_steps")
        self.i = FIRST

    def _noise(self):
        return T.noise(self.gen, self.ref_cfg, self.B, self.dev)

    def unit_call(self):
        """One timed step: until its loss is on the host."""
        m = self.step(self.models, self.opt,
                      self.pool[self.i % len(self.pool)], noise=self._noise())
        float(m["loss"])
        self.i += 1

    def e2e(self, times, window_s) -> dict:
        return {"train_samples_per_s": self.B * len(times) / window_s}

    def release(self):
        self.pool = self.pool[:FIRST]
        self.models = self.opt = self.step = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_run(self):
        """The reference's first steps: (losses, first gradients'
        norms, changes' norms, each leaf's share of first-gradient
        elements under SMALL)."""
        models = copy.deepcopy(self.ref_models)
        opt = RD.adam(models, self.lr)
        step = RD.make_full_train_step(self.ref_cfg, v2=True, mode="full",
                                       compute_dtype=self.cdt,
                                       remat=self.remat)
        losses = []
        for k in range(FIRST):
            m = step(models, opt, self.pool[k], noise=self.noises[k])
            losses.append(float(m["loss"]))
            if k == 0:
                grads = first_grads(models, opt)
                small = small_share(models, opt)
        out = losses, grads, changes(models, self.ref_models), small
        del models, opt
        return out

    def check(self, control: bool = False):
        prec = self.config["precision"]
        losses, grads, change = self.losses, self.grads, self.change
        if control:
            tf32(True)
            losses, grads, change, _ = self._ref_run()
            tf32(prec["tf32"])
        self.ref = self._ref_run()
        self.got = losses, grads, change
        numbers = compare(losses, grads, change, *self.ref[:3])
        return numbers, self._per_step()

    def witness(self) -> dict:
        """The reference's second run against its first, by `compare`
        (`self_*`), and the leaves behind the largest gaps of the
        program's run and of that second run."""
        again = self._ref_run()
        out = {f"self_{k}": v
               for k, v in compare(*again[:3], *self.ref[:3]).items()}
        out["leaves"] = worst_leaves(*self.got[1:], *self.ref[1:])
        out["self_leaves"] = worst_leaves(*again[1:3], *self.ref[1:])
        return out

    def _per_step(self) -> dict:
        """The least work of one step of the whole batch, counted on the
        reference's step over COUNT_ROWS rows without remat."""
        from torch.utils.flop_counter import FlopCounterMode

        models = copy.deepcopy(self.ref_models)
        opt = RD.adam(models, self.lr)
        step = RD.make_full_train_step(self.ref_cfg, v2=True, mode="full",
                                       compute_dtype=self.cdt, remat=False)
        rows = slice(0, COUNT_ROWS)
        batch = {k: v[rows] for k, v in self.pool[0].items()}
        noise = {k: v[rows] for k, v in self.noises[0].items()}
        record.CALLS = []
        try:
            with FlopCounterMode(display=False) as fc:
                step(models, opt, batch, noise=noise)
            calls = record.CALLS
        finally:
            record.CALLS = None
        return counts.per_unit(
            calls, fc.get_total_flops(), self.B / COUNT_ROWS,
            counts.PEAKS[self.config["precision"]["compute_dtype"]])


def first_grads(models, opt) -> dict:
    """{leaf: norm of the gradient Adam took at its first step}, from its
    first moment: m1 = (1 - beta1) g."""
    out = {}
    for name, p in models.named_parameters():
        st = opt.state.get(p)
        if st and "exp_avg" in st:
            out[name] = float((st["exp_avg"].double() / (1 - BETA1)).norm())
    return out


SMALL = 1e-6   # a first gradient's element under it: Adam's step is less
               # than lr / (1 + eps / SMALL) ~ lr, but its sign is round-off


def small_share(models, opt) -> dict:
    """{leaf: share of its first gradient's elements under SMALL in
    magnitude}."""
    out = {}
    for name, p in models.named_parameters():
        st = opt.state.get(p)
        if st and "exp_avg" in st:
            g = st["exp_avg"] / (1 - BETA1)
            out[name] = float((g.abs() < SMALL).float().mean())
    return out


def worst_leaves(grads, change, r_grads, r_change, small, n=3) -> dict:
    """The `n` leaves with the largest gaps of the first gradient's norm
    and of the change's norm, each as [gap, program norm, reference
    norm, median leaf's reference norm, share of small elements]."""
    out = {}
    for key, p, r in (("grad", grads, r_grads), ("change", change, r_change)):
        med = float(np.median(list(r.values())))
        rows = sorted(((abs(p.get(k, 0.0) - r[k]) / max(r[k], med, 1e-30),
                        k) for k in r), reverse=True)[:n]
        out[key] = {k: [g, p.get(k), r[k], med, small.get(k)]
                    for g, k in rows}
    return out


def changes(models, start) -> dict:
    """{leaf: norm of its change from `start`'s weights}."""
    ref = dict(start.named_parameters())
    return {name: float((p.detach().double() - ref[name].detach().double()
                         ).norm())
            for name, p in models.named_parameters() if p.requires_grad}


def compare(losses, grads, change, r_losses, r_grads, r_change) -> dict:
    """loss: the largest relative gap of a step's loss (loss1: the first
    step's); grad, change: the worst leaf's gap of norms against the
    larger of its reference norm and the median leaf's (`_med`: the
    median leaf's gap)."""
    gaps_l = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(losses, r_losses)]
    loss, loss1 = max(gaps_l), gaps_l[0]

    def gaps(p, r, leaves):
        med = float(np.median([r[k] for k in leaves])) if leaves else 0.0
        return [abs(p.get(k, 0.0) - r[k]) / max(r[k], med, 1e-30)
                for k in leaves] or [0.0]

    g_leaves = sorted(r_grads)
    med_g = float(np.median([r_grads[k] for k in g_leaves]))
    moved = [k for k in g_leaves if r_grads[k] >= 1e-3 * med_g]
    if set(grads) != set(r_grads):
        return dict(loss=loss, loss1=loss1, grad=1e9, change=1e9,
                    grad_med=1e9, change_med=1e9)
    g, c = gaps(grads, r_grads, g_leaves), gaps(change, r_change, moved)
    return dict(loss=loss, loss1=loss1, grad=max(g), change=max(c),
                grad_med=float(np.median(g)), change_med=float(np.median(c)))


Loop = Distill
