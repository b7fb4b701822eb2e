"""Windowed PID controller over a rolling error buffer, batched over egos
(counterpart of `lav_tpu/agent/pid.py`): I-term = window mean, D-term =
last difference."""

from __future__ import annotations

import torch


def pid_make(K_P: float, K_I: float, K_D: float, n: int):
    return dict(K_P=K_P, K_I=K_I, K_D=K_D, n=n)


def pid_init(num_ego: int, n: int, device=None):
    return torch.zeros((num_ego, n), device=device)


def pid_step(consts, window, error):
    """window (E, n), error (E,) -> (control (E,), new window)."""
    window = torch.cat([window[:, 1:], error[:, None]], dim=1)
    integral = window.mean(dim=1)
    derivative = window[:, -1] - window[:, -2]
    out = (consts["K_P"] * error + consts["K_I"] * integral
           + consts["K_D"] * derivative)
    return out, window
