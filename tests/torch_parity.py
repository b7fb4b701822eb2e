"""Closeness checks shared by the port's parity tests (tests/test_torch_*.py).

`assert_close` asserts like numpy's assert_allclose and, when the
environment variable LAV_PARITY_LOG names a file, appends one JSON line
per check with its max abs error.  Summarise such a log per check name:

    LAV_PARITY_LOG=/tmp/parity.jsonl python -m pytest tests/test_torch_*.py -q
    python tests/torch_parity.py /tmp/parity.jsonl
"""

import json
import os
import sys

import numpy as np


def _f64(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float64)


def assert_close(name, got, want, atol, rtol=0.0):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    path = os.environ.get("LAV_PARITY_LOG")
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"check": name, "max_abs_err": err,
                                "atol": atol, "rtol": rtol}) + "\n")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=name)


def jax_tree(module):
    """The lav_tpu params tree (numpy arrays) of a port module: the
    inverse of lav_tpu_torch/utils/weights.py's conversions, so that a
    test can start both packages from the port's fast initialisers."""
    from lav_tpu_torch.nn import layers as L

    def a(t, perm=None):
        t = t.detach()
        return (t if perm is None else t.permute(*perm)).numpy().copy()

    kind = type(module)
    if kind in (L.Linear, L.Conv2d, L.ConvTranspose2d, L.LinearBank):
        perm = {L.Linear: (1, 0), L.Conv2d: (2, 3, 1, 0),
                L.ConvTranspose2d: (2, 3, 0, 1),
                L.LinearBank: (0, 2, 1)}[kind]
        d = {"w": a(module.w, perm)}
        if module.b is not None:
            d["b"] = a(module.b)
        return d
    if kind is L.BatchNorm:
        return {k: a(getattr(module, k)) for k in ("scale", "bias", "mean",
                                                    "var")}
    if kind in (L.GRU, L.GRUBank):
        sw = tuple(range(module.w_ih.ndim - 2)) + (-1, -2)
        return {"w_ih": a(module.w_ih, sw), "w_hh": a(module.w_hh, sw),
                "b_ih": a(module.b_ih), "b_hh": a(module.b_hh)}
    tree = {name: a(p) for name, p in module.named_parameters(recurse=False)}
    tree.update((name, jax_tree(child))
                for name, child in module.named_children())
    return tree


def check_grads(tag, models, metrics, ref_metrics, want, tol):
    """A train step's metrics and gradients against lav_tpu's: each
    metric to rtol `tol["metric"]` (`tol["grad_norm"]` for grad_norm),
    each gradient leaf in L2, |g_port - g_ref| <= tol["leaf"] |g_ref| +
    tol["floor"] grad_norm, and all leaves together to tol["all"]
    grad_norm.  `want` is a port module holding lav_tpu's gradients."""
    for k, v in ref_metrics.items():
        rtol = tol["grad_norm"] if k == "grad_norm" else tol["metric"]
        assert_close(f"{tag}.{k}", metrics[k], v, atol=0, rtol=rtol)
    want = dict(want.named_parameters())
    gnorm = float(ref_metrics["grad_norm"])
    total = 0.0
    for name, p in models.named_parameters():
        got = p.grad if p.grad is not None else p.new_zeros(p.shape)
        err = float((got.detach() - want[name].detach()).norm())
        total += err * err
        scale = float(want[name].detach().norm())
        assert err <= tol["leaf"] * scale + tol["floor"] * gnorm, (
            tag, name, err, scale)
    assert total ** 0.5 <= tol["all"] * gnorm, (tag, total ** 0.5, gnorm)


def check_update(tag, models, want_params, want_grads, upd_tol, close, lr,
                 stat_tol, sure_g=1e-4, sure_rel=1e-3):
    """Updated params and BN running statistics against lav_tpu's (port
    modules holding its trees).  Adam's first step is lr * g / (|g| +
    eps), about lr * sign(g), and a sign is noise where |g| is: so a
    param is held to `upd_tol` + 1e-6 |p| only where |g_ref| >= sure_g and
    the port's gradient is within sure_rel of it, in this step and every
    one before (`close`, name -> mask, updated here); elsewhere within
    Adam's bound, 2 lr.  Buffers (the BN statistics, which come from the
    forward) to atol = rtol = stat_tol."""
    want = dict(want_params.named_parameters())
    grads = dict(want_grads.named_parameters())
    for name, p in models.named_parameters():
        g, w = grads[name].detach(), want[name].detach()
        mine = p.grad if p.grad is not None else p.new_zeros(p.shape)
        err = (p.detach() - w).abs()
        sure = close.get(name, True) & (g.abs() >= sure_g) & (
            (mine - g).abs() <= sure_rel * g.abs())
        close[name] = sure
        if sure.any():
            worst = float((err[sure] - upd_tol - 1e-6 * w[sure].abs()).max())
            assert worst <= 0, (tag, name, worst)
        assert float(err.max()) <= 2 * lr + 1e-6, (tag, name)
    bufs = dict(want_params.named_buffers())
    for name, b in models.named_buffers():
        assert_close(f"{tag}.{name}", b, bufs[name], atol=stat_tol,
                     rtol=stat_tol)


def summarise(path):
    """Max abs error and tolerance per check name, as markdown rows."""
    worst = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            w = worst.setdefault(r["check"], [0.0, r["atol"], r["rtol"]])
            w[0] = max(w[0], r["max_abs_err"])
    rows = ["| check | max abs err | atol | rtol |", "|---|---|---|---|"]
    for name in sorted(worst):
        err, atol, rtol = worst[name]
        rows.append(f"| {name} | {err:.3g} | {atol:g} | {rtol:g} |")
    return "\n".join(rows)


if __name__ == "__main__":
    print(summarise(sys.argv[1]))
