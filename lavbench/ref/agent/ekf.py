"""Extended Kalman filter for the ego pose (x, y, theta), batched over egos
(counterpart of `lav_tpu/agent/ekf.py`): kinematic-bicycle prediction,
GPS + compass update with fixed noise, F = H = I.

LAV's quirk is kept on purpose: the heading prediction uses tan(theta),
the current heading, not the wheel angle — the deployed policy was tuned
against this filter.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

EARTH_RADIUS = 6371e3


class EKFState(NamedTuple):
    x: torch.Tensor            # (E, 3) [x, y, theta]
    P: torch.Tensor            # (E, 3, 3) covariance
    initialized: torch.Tensor  # (E,) bool


def ekf_make(cos0: float = 1.0, lf: float = 1.477531, lr: float = 1.393600,
             gnss_noise: float = 0.000005, compass_noise: float = 1e-7,
             max_steer_angle: float = 70.0, freq: float = 20.0,
             device=None):
    """The constants shared by all EKF calls."""
    xy_noise = EARTH_RADIUS * gnss_noise * math.pi / 180.0
    cps_noise = compass_noise * math.pi / 180.0
    return dict(
        Q=torch.eye(3, device=device) * 1e-7,
        R=torch.diag(torch.tensor([xy_noise ** 2, xy_noise ** 2,
                                   cps_noise ** 2], device=device)),
        max_steer=max_steer_angle * math.pi / 180.0,
        cos0=cos0, lr=lr, L=lf + lr, dt=1.0 / freq,
    )


def ekf_init_state(num_ego: int, device=None) -> EKFState:
    return EKFState(
        x=torch.zeros((num_ego, 3), device=device),
        P=torch.zeros((num_ego, 3, 3), device=device),
        initialized=torch.zeros((num_ego,), dtype=torch.bool, device=device),
    )


def latlon_to_xy(consts, lat, lon):
    x = EARTH_RADIUS * lat * (math.pi / 180.0)
    y = (EARTH_RADIUS * lon * (math.pi / 180.0)
         * math.cos(consts["cos0"]))
    return x, y


def _kbm_step(consts, x, spd, steer):
    """Kinematic bicycle prediction; x (E, 3), spd and steer (E,)."""
    xk, yk, theta = x[:, 0], x[:, 1], x[:, 2]
    wheel = steer * consts["max_steer"]
    beta = torch.atan(consts["lr"] * torch.tan(wheel) / consts["L"])
    dt = consts["dt"]
    xp = xk + spd * torch.cos(theta + beta) * dt
    yp = yk + spd * torch.sin(theta + beta) * dt
    tp = theta + spd * torch.tan(theta) * torch.cos(beta) / consts["L"] * dt
    return torch.stack([xp, yp, tp], dim=-1)


def _inv3(S):
    """Closed-form inverse (adjugate / determinant) of S (E, 3, 3)."""
    a, b, c = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    d, e, f = S[:, 1, 0], S[:, 1, 1], S[:, 1, 2]
    g, h, i = S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([C, b * g - a * h, a * e - b * d], -1),
    ], dim=-2)
    return adj / det[:, None, None]


def ekf_predict_update(consts, state: EKFState, spd, steer, lat, lon,
                       compass) -> EKFState:
    """One predict + update per ego; an uninitialised ego latches the
    measurement instead.  compass is already ori (= raw compass - pi/2)."""
    x_gps, y_gps = latlon_to_xy(consts, lat, lon)
    z = torch.stack([x_gps, y_gps, compass], dim=-1)
    x_pred = _kbm_step(consts, state.x, spd, steer)
    P_pred = state.P + consts["Q"]
    S = P_pred + consts["R"]
    K = P_pred @ _inv3(S)
    x_new = x_pred + (K @ (z - x_pred)[..., None])[..., 0]
    eye = torch.eye(3, device=K.device, dtype=K.dtype)
    P_new = (eye - K) @ P_pred
    init = state.initialized
    return EKFState(
        x=torch.where(init[:, None], x_new, z),
        P=torch.where(init[:, None, None], P_new, torch.zeros_like(P_new)),
        initialized=torch.ones_like(init),
    )


def ekf_select(cond, a: EKFState, b: EKFState) -> EKFState:
    """Per ego: a where cond (E,) else b."""
    return EKFState(
        x=torch.where(cond[:, None], a.x, b.x),
        P=torch.where(cond[:, None, None], a.P, b.P),
        initialized=torch.where(cond, a.initialized, b.initialized),
    )
