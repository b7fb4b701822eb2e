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
    return {name: jax_tree(child) for name, child in module.named_children()}


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
