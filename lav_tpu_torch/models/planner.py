"""UniPlanner inference (counterpart of the inference subset of
`lav_tpu/models/planner.py`).

The planner core: a bank of per-command cast GRUs (stacked weights), a
shared plan GRU refined `num_plan_iter` times, cumulative-sum waypoint
decoding as a lower-triangular matmul, and a command classifier.
LAV's quirk is kept: forecasts of other vehicles use the EGO cast bank.

`uniplanner_infer` is batched over egos and always takes lav_tpu's folded
form: the ego crop joins the K detection crops, so one `crop_shared`
launch and one (K+1)-batch ResNet pass serve every crop of every ego.
When the crop ResNet's `conv1` is int8 with a calibrated `x_scale`, the
crops come out int8, quantized with that scale in the crop kernel's
epilogue (lav_tpu `planner.py:551-568`), and `conv1` consumes them as
they are; in calibration the crops stay float so that `conv1` observes
them.
"""

from __future__ import annotations

import torch
from torch import nn

from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.core.geometry import transform_points
from lav_tpu_torch.core.warp import crop_feature_shared
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn import quant
from lav_tpu_torch.nn.resnet import resnet18, resnet_apply

EMBD = 512  # resnet18 layer4 channels / plan GRU hidden size


class UniPlanner(nn.Module):
    # lav_tpu params the inference path never reads: the frozen BEV
    # teacher and the never-evaluated `other` cast bank
    jax_unused = ("bev_planner", "cast_grus_other", "cast_mlps_other")

    def __init__(self, cfg: LAVConfig, gen=None):
        super().__init__()
        C = cfg.num_cmds
        self.lidar_conv_emb = resnet18(cfg.uniplanner_input_channels, gen=gen)
        self.plan_gru = L.GRU(4, EMBD, gen=gen)
        self.plan_mlp = L.Linear(EMBD, 2, gen=gen)
        self.cast_grus = L.GRUBank(C, EMBD, 64, gen=gen)
        self.cast_mlps = L.LinearBank(C, 64, 2, gen=gen)
        self.cast_cmd_pred = L.Linear(EMBD, C, gen=gen)


def cumsum_time(x):
    """Cumulative sum over the plan-time axis 1 of x (B, T, d), as one
    lower-triangular matmul."""
    T = x.shape[1]
    tri = torch.tril(torch.ones((T, T), dtype=x.dtype, device=x.device))
    return torch.einsum("ts,bsd->btd", tri, x)


def cast(core: UniPlanner, embd, num_plan: int):
    """embd (B, EMBD) -> per-command trajectories (B, num_cmds, T, 2)."""
    B = embd.shape[0]
    u = embd[:, None].expand(B, num_plan, embd.shape[-1])
    out = core.cast_mlps(core.cast_grus(u))          # (C, B, T, 2)
    n = out.shape[0]
    locs = cumsum_time(out.reshape(n * B, num_plan, 2))
    return locs.reshape(n, B, num_plan, 2).transpose(0, 1)


def cast_cmd_pred(core: UniPlanner, embd):
    return torch.sigmoid(core.cast_cmd_pred(embd))


def _plan_once(core: UniPlanner, embd, nxp, cast_locs, *, num_plan: int,
               pixels_per_meter: float, crop_size: int):
    """One refinement pass; all commands share the plan GRU as one batch."""
    B, C = cast_locs.shape[0], cast_locs.shape[1]
    u0 = nxp * pixels_per_meter / crop_size * 2.0 - 1.0
    u0 = u0[:, None, None].expand(B, C, num_plan, 2)
    u = torch.cat([u0, cast_locs], dim=-1).reshape(B * C, num_plan, 4)
    h0 = embd[:, None].expand(B, C, EMBD).reshape(B * C, EMBD)
    out, _ = core.plan_gru(u, h0)
    locs = cumsum_time(core.plan_mlp(out))
    return locs.reshape(B, C, num_plan, 2) + cast_locs


def plan(core: UniPlanner, embd, nxp, cast_locs, *, num_plan: int,
         num_plan_iter: int, pixels_per_meter: float, crop_size: int):
    """Iterative refinement -> (B, num_plan_iter, C, T, 2)."""
    loc, outs = cast_locs, []
    for _ in range(num_plan_iter):
        loc = _plan_once(core, embd, nxp, loc, num_plan=num_plan,
                         pixels_per_meter=pixels_per_meter,
                         crop_size=crop_size)
        outs.append(loc)
    return torch.stack(outs, dim=1)


def conv_emb(net, x):
    """ResNet embedding of NHWC crops, pooled and kept in f32 for the GRUs."""
    return resnet_apply(net, x).mean(dim=(1, 2)).float()


def uniplanner_infer(core: UniPlanner, cfg: LAVConfig, features, det, cmd,
                     nxp):
    """Fused planner inference for B egos.

    features (B, Hf, Wf, Cf) lidar backbone maps; det: vehicle-class
    detections, each of x, y, cos, sin, valid shaped (B, K); cmd (B,) int;
    nxp (B, 2).  Returns ego_plan_locs (B, T, 2), ego_cast_cmd_locs
    (B, T, 2), other_cast_locs (B, K, C, T, 2) in the ego frame,
    other_cast_cmds (B, K, C) and other_valid (B, K)."""
    B, Hf, Wf, _ = features.shape
    H, W = Hf * 2, Wf * 2
    center_x = W / 2.0
    center_y = H / 2.0 + cfg.y_offset * H / 2.0
    ppm = cfg.pixels_per_meter
    T = cfg.num_plan

    x, y = det["x"].float(), det["y"].float()
    d2 = (x - center_x) ** 2 + (y - center_y) ** 2
    ovalid = det["valid"] & (d2 > 4.0 ** 2)
    olocs = torch.stack([(x - center_x) / ppm, (y - center_y) / ppm], -1)
    ooris = torch.atan2(det["sin"].float(), det["cos"].float())
    K = olocs.shape[1]

    all_locs = torch.cat([olocs, olocs.new_zeros((B, 1, 2))], dim=1)
    all_oris = torch.cat([ooris, ooris.new_zeros((B, 1))], dim=1)
    c1 = core.lidar_conv_emb.conv1
    q8 = (c1.x_scale if c1.w_int8 is not None and not quant.calibrating()
          else None)
    crops = crop_feature_shared(features, all_locs, all_oris,
                                pixels_per_meter=ppm / 2,
                                crop_size=cfg.crop_size,
                                offset_y=cfg.y_offset, q8_x_scale=q8)
    embd = conv_emb(core.lidar_conv_emb,
                    crops.reshape(B * (K + 1), *crops.shape[2:]))
    all_cast = cast(core, embd, T).reshape(B, K + 1, cfg.num_cmds, T, 2)
    embd = embd.reshape(B, K + 1, EMBD)
    other_cast_locs, ego_cast_locs = all_cast[:, :K], all_cast[:, K]
    other_cast_cmds = cast_cmd_pred(core, embd[:, :K])
    other_cast_locs = (transform_points(other_cast_locs,
                                        ooris[:, :, None, None])
                       + olocs[:, :, None, None])

    ego_plan_all = plan(core, embd[:, K], nxp, ego_cast_locs, num_plan=T,
                        num_plan_iter=cfg.num_plan_iter,
                        pixels_per_meter=ppm, crop_size=cfg.crop_size * 2)
    ar = torch.arange(B, device=features.device)
    cmd = cmd.long()
    return (ego_plan_all[ar, -1, cmd], ego_cast_locs[ar, cmd],
            other_cast_locs, other_cast_cmds, ovalid)
