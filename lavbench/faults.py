"""Faults planted underneath the timed path, for the readings of the
limits and for the tests that see `correct` come out false: a step that
returns its state unchanged, half of the batch left out (the rest's
answers, or the mean over the rest, standing for it), and an answer
altered where it is produced.  Each wraps the program's own entry
(`build_agent`'s step, `make_full_train_step`'s step); the check is not
touched."""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


def _agent(fault):
    import lav_tpu_torch.agent.agent as A

    real = A.build_agent

    def build_agent(*args, **kw):
        init, step = real(*args, **kw)
        if kw.get("num_ego", 1) < 2:        # the calibration's agent
            return init, step

        def broken(models, state, obs):
            ctrl, new, aux = step(models, state, obs)
            if fault == "unchanged":
                return ctrl, state, aux
            if fault == "altered":
                return ctrl._replace(steer=ctrl.steer + 0.05), new, aux
            idx = torch.arange(ctrl.steer.shape[0],
                               device=ctrl.steer.device)
            idx = idx % max(idx.numel() // 2, 1)

            def spread(t):
                return t[idx] if isinstance(t, torch.Tensor) else t
            aux = {k: ({kk: spread(vv) for kk, vv in v.items()}
                       if isinstance(v, dict) else spread(v))
                   for k, v in aux.items()}
            return type(ctrl)(*map(spread, ctrl)), new, aux
        return init, broken

    return A, "build_agent", build_agent


def _distill(fault):
    import lav_tpu_torch.train.distill as DS

    real = DS.make_full_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def broken(models, optimizer, batch, gen=None, noise=None):
            if fault == "half":
                half = batch["typs"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
                noise = {k: v[:half] for k, v in noise.items()}
            if fault == "unchanged":
                saved = ([p.detach().clone() for p in models.parameters()],
                         {p: {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in s.items()}
                          for p, s in optimizer.state.items()})
            m = step(models, optimizer, batch, gen, noise)
            if fault == "unchanged":
                with torch.no_grad():
                    for p, b in zip(models.parameters(), saved[0]):
                        p.copy_(b)
                optimizer.state.clear()
                optimizer.state.update(saved[1])
            if fault == "altered":
                m = dict(m, loss=m["loss"] * 1.01)
            return m
        return broken

    return DS, "make_full_train_step", make


@contextlib.contextmanager
def planted(fault: str, loop: str):
    """The program's entry of `loop` ('agent' or 'distill') broken by
    `fault` meanwhile."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    mod, name, broken = (_agent if loop == "agent" else _distill)(fault)
    real = getattr(mod, name)
    setattr(mod, name, broken)
    try:
        yield
    finally:
        setattr(mod, name, real)
