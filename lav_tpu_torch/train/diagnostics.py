"""Train-time inference probes: eval-mode detection and planning on sample
0 (counterpart of `lav_tpu/train/diagnostics.py`).

The reference re-runs inference on the first batch item at every logging
step (lav_final.py:190-198, 240-273 `det_inference` / `mot_inference`)
as an inline integration check; these probes do the same and return
fixed-shape tensors for the figure builders (`utils/figures.py`
`det_panel` / `bev_panel`).  A probe runs its models in eval mode and
puts back the mode they were in; on the card the lidar probe launches
the pillar scatters (`scatter_add`, `scatter_max`) and the planner's
crops (`crop_shared`), the BEV probe the BEV crop.
"""

from __future__ import annotations

import contextlib

import torch

from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.models.planner import bev_planner_infer, uniplanner_infer
from lav_tpu_torch.ops.peak import det_inference


@contextlib.contextmanager
def _eval(*modules):
    modes = [m.training for m in modules]
    try:
        for m in modules:
            m.eval()
        with torch.no_grad():
            yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)


def make_lidar_probe(cfg: LAVConfig):
    """probe(models, lidar (P, D), valid (P,), cmd (), nxp (2,)) -> dict
    of detections (every class, (C, K) each) and plans, all eval-mode
    (LAV's mot_inference); models holds `lidar_model` and `uniplanner`
    (`AgentModels`, or the distillation step's `distill_models`)."""
    H, W = cfg.ny, cfg.nx
    ego_px = (W / 2.0, H / 2.0 + cfg.y_offset * H / 2.0)

    def probe(models, lidar, valid, cmd, nxp):
        lm, up = models.lidar_model, models.uniplanner
        with _eval(lm, up):
            feats, hm, size, ori, bev = lm(lidar[None], valid[None])
            dets = det_inference(
                torch.sigmoid(hm.float()), size.float(), ori.float(),
                pixels_per_meter=cfg.pixels_per_meter, max_det=cfg.max_det,
                min_score=0.2, ego_xy=ego_px)
            veh = {k: v[:, 1] for k, v in dets._asdict().items()}
            plan, _, other_locs, other_cmds, other_valid = uniplanner_infer(
                up, cfg, feats, veh, cmd.reshape(1), nxp.reshape(1, 2))
        return dict(
            dets={k: v[0] for k, v in dets._asdict().items()},
            pred_bev=bev[0],
            ego_plan_locs=plan[0],
            other_cast_locs=other_locs[0],
            other_cast_cmds=other_cmds[0],
            other_valid=other_valid[0],
        )

    return probe


def make_bev_probe(cfg: LAVConfig):
    """probe(planner, bev (H, W, C), nxp (2,)) -> the BEV planner's plan
    (its last iteration), casts and command scores, eval-mode."""

    def probe(planner, bev, nxp):
        with _eval(planner):
            plan, cast_locs, cmds = bev_planner_infer(planner, cfg,
                                                      bev[None], nxp[None])
        return dict(
            ego_plan_locs=plan[0, -1],
            ego_cast_locs=cast_locs[0],
            ego_cast_cmds=cmds[0],
        )

    return probe
