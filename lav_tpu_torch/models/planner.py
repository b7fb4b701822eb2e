"""UniPlanner inference and training forward, and the frozen BEVPlanner
teacher (counterpart of `lav_tpu/models/planner.py`).

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
them.  With `s2d_crops` (lav_tpu's `LAV_S2D_CROPS=1`) such q8 crops of
even size come out space-to-depth and `conv1` runs as the 4x4 stride-1
`quant.conv2d_int8_s2d`.

`uniplanner_forward` is the distillation step's student forward with the
frozen teacher in it (lav_tpu `planner.py:343-492`): up to K other cars
picked at random among the vehicles ahead (`select_cars`), the student's
crops of the lidar features and the teacher's crops of the ground-truth
BEV, jittered, then the ego's.  Its noise comes drawn (`draw_noise`), so a
test can hand it lav_tpu's draws.  The teacher (`UniPlanner(cfg,
teacher=True).bev_planner`) stays in eval mode with no gradient; the
student's crop ResNet runs in train mode, called on the other cars'
crops, then on the ego's: its BN update is the ego call's (lav_tpu keeps
`{"lidar_conv_emb": st_ego}`), which `BatchNorm.new_stats` gives, since
the later call overwrites it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.core.geometry import transform_points
from lav_tpu_torch.core.warp import crop_feature, crop_feature_shared
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn import quant
from lav_tpu_torch.nn.resnet import resnet18, resnet_apply

EMBD = 512  # resnet18 layer4 channels / plan GRU hidden size


def _add_core(m: nn.Module, C: int, gen) -> None:
    """The cast/plan core shared by both planners."""
    m.plan_gru = L.GRU(4, EMBD, gen=gen)
    m.plan_mlp = L.Linear(EMBD, 2, gen=gen)
    m.cast_grus = L.GRUBank(C, EMBD, 64, gen=gen)
    m.cast_mlps = L.LinearBank(C, 64, 2, gen=gen)
    m.cast_cmd_pred = L.Linear(EMBD, C, gen=gen)


class BEVPlanner(nn.Module):
    """The privileged planner: a ResNet18 over BEV crops and its own core
    (lav_tpu `bev_planner_init`)."""

    def __init__(self, cfg: LAVConfig, gen=None):
        super().__init__()
        self.bev_conv_emb = resnet18(cfg.bev_input_channels, gen=gen)
        _add_core(self, cfg.num_cmds, gen)


class UniPlanner(nn.Module):
    """The student planner.  With `teacher=True` it also holds lav_tpu's
    training-only leaves: the frozen `bev_planner` (eval mode in either
    mode of this module, no gradient) and the `other` cast bank, which
    LAV never evaluates (its forecasts of other cars use the ego bank),
    so it gets no gradient and no update.  Without, the loader skips
    them (`jax_unused`)."""

    def __init__(self, cfg: LAVConfig, gen=None, teacher: bool = False):
        super().__init__()
        C = cfg.num_cmds
        self.lidar_conv_emb = resnet18(cfg.uniplanner_input_channels, gen=gen)
        _add_core(self, C, gen)
        self.jax_unused = ("bev_planner", "cast_grus_other",
                           "cast_mlps_other")
        if teacher:
            self.jax_unused = ()
            self.cast_grus_other = L.GRUBank(C, EMBD, 64, gen=gen)
            self.cast_mlps_other = L.LinearBank(C, 64, 2, gen=gen)
            self.bev_planner = BEVPlanner(cfg, gen=gen).requires_grad_(False)
        self.eval()   # inference unless a caller asks for train mode

    def train(self, mode: bool = True):
        super().train(mode)
        if hasattr(self, "bev_planner"):
            self.bev_planner.eval()
        return self


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
    loc, outs = cast_locs.detach(), []
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
                     nxp, s2d_crops: bool = False):
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
    s2d = s2d_crops and q8 is not None and cfg.crop_size % 2 == 0
    crops = crop_feature_shared(features, all_locs, all_oris,
                                pixels_per_meter=ppm / 2,
                                crop_size=cfg.crop_size,
                                offset_y=cfg.y_offset, q8_x_scale=q8, s2d=s2d)
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


# ---------------------------------------------------------------------------
# training forward (lav_tpu planner.py:134-150, 182-193, 343-492)
# ---------------------------------------------------------------------------

class UniPlannerOutputs(NamedTuple):
    other_locs: torch.Tensor              # (B, K, T, 2)
    other_cast_locs: torch.Tensor         # (B, K, C, T, 2) student
    other_cast_cmds: torch.Tensor         # (B, K, C) student
    other_cast_locs_expert: torch.Tensor  # (B, K, C, T, 2) teacher
    other_cast_cmds_expert: torch.Tensor  # (B, K, C)
    ego_locs: torch.Tensor                # (B, T, 2) jittered GT future
    ego_plan_locs: torch.Tensor           # (B, I, C, T, 2)
    ego_cast_locs: torch.Tensor           # (B, C, T, 2)
    ego_cast_cmds: torch.Tensor           # (B, C)
    ego_cast_locs_expert: torch.Tensor    # (B, C, T, 2)
    ego_plan_locs_expert: torch.Tensor    # (B, I, C, T, 2)
    car_valid: torch.Tensor               # (B, K) bool


def draw_noise(gen, B: int, N: int, K: int, device=None) -> dict:
    """The uniform draws of one student forward, on the CPU generator
    `gen`, moved to `device`: `scores` (B, N) for the car pick among the
    N other slots, `loc_o` (B, K, 2) and `ori_o` (B, K) for the other
    cars' crop jitter, `loc_e` (B, 2) and `ori_e` (B,) for the ego's."""
    shapes = dict(scores=(B, N), loc_o=(B, K, 2), ori_o=(B, K),
                  loc_e=(B, 2), ori_e=(B,))
    return {k: torch.rand(v, generator=gen).to(device)
            for k, v in shapes.items()}


def select_cars(scores_u, ego_locs, locs, typs, max_num_cars: int):
    """Pick up to `max_num_cars` slots per item among the vehicles
    (typ 1) ahead of the ego (rel y < 0), by the uniform scores
    `scores_u` (B, N); locs (B, N, T+1, 2), typs (B, N).  Returns (idx
    (B, K) int64, car_valid (B, K) bool).  lav_tpu takes `lax.top_k`,
    whose ties (the -inf of every slot that does not qualify) go to the
    lowest index; a stable descending sort does the same here, so that
    the invalid slots, whose crops still enter the BN statistics, are
    lav_tpu's."""
    rel = locs[:, :, 0] - ego_locs[:, None, 0]
    mask = (typs == 1) & (rel[..., 1] < 0)
    scores = torch.where(mask, scores_u,
                         torch.full_like(scores_u, -math.inf))
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return idx[:, :max_num_cars], torch.isfinite(top[:, :max_num_cars])


def gather_cars(arr, idx):
    """arr (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return arr[torch.arange(arr.shape[0], device=arr.device)[:, None], idx]


def jitter(u_loc, u_ori, feature_x_jitter: float, angle_rad: float):
    """Crop jitter from uniform draws: loc (..., 2) in
    [-feature_x_jitter, feature_x_jitter) with its y set to 0, ori (...)
    in [-angle_rad, angle_rad)."""
    loc = (u_loc * 2 - 1) * feature_x_jitter
    loc = torch.stack([loc[..., 0], torch.zeros_like(loc[..., 1])], -1)
    return loc, (u_ori * 2 - 1) * angle_rad


def uniplanner_forward(core: UniPlanner, cfg: LAVConfig, features, bev,
                       ego_locs, locs, oris, nxps, typs, noise):
    """Student forward with the frozen teacher (lav_tpu
    `uniplanner_forward`, train=True when `core` is in train mode, else
    no jitter).  features (B, Hf, Wf, Cf) the lidar backbone's maps; bev
    (B, H, W, Cin) the ground-truth BEV; ego_locs (B, T+1, 2); locs (B, N,
    T+1, 2), oris (B, N), typs (B, N) with slot 0 the ego; nxps (B, 2);
    noise from `draw_noise`.  Returns UniPlannerOutputs."""
    B = features.shape[0]
    K = cfg.max_num_cars_student
    T, I = cfg.num_plan, cfg.num_plan_iter
    ppm, crop = cfg.pixels_per_meter, cfg.crop_size
    ang = math.radians(cfg.feature_angle_jitter)
    teacher = core.bev_planner
    train = core.training

    ego_oris = oris[:, 0]
    o_locs, o_oris, o_typs = locs[:, 1:], oris[:, 1:], typs[:, 1:]
    idx, car_valid = select_cars(noise["scores"], ego_locs, o_locs, o_typs,
                                 K)
    sel_locs = gather_cars(o_locs, idx)
    sel_oris = gather_cars(o_oris, idx)
    rel_loc0 = sel_locs[:, :, 0] - ego_locs[:, None, 0]
    rel_ori0 = sel_oris - ego_oris[:, None]
    fut = sel_locs[:, :, 1:] - sel_locs[:, :, :1]
    if train:
        loc_jit, ori_jit = jitter(noise["loc_o"], noise["ori_o"],
                                  cfg.feature_x_jitter, ang)
        eloc_jit, eori_jit = jitter(noise["loc_e"], noise["ori_e"],
                                    cfg.feature_x_jitter, ang)
    else:
        loc_jit, ori_jit = torch.zeros_like(rel_loc0), torch.zeros_like(
            rel_ori0)
        eloc_jit, eori_jit = ego_locs.new_zeros((B, 2)), torch.zeros_like(
            ego_oris)
    crop_locs, crop_oris = rel_loc0 + loc_jit, rel_ori0 + ori_jit
    other_locs = transform_points(fut - loc_jit[:, :, None],
                                  -rel_ori0 - ori_jit)

    def multi_crop(src, pixels_per_meter, size):
        out = crop_feature_shared(src, crop_locs, crop_oris,
                                  pixels_per_meter=pixels_per_meter,
                                  crop_size=size, offset_y=cfg.y_offset)
        return out.reshape(B * K, *out.shape[2:])

    with torch.no_grad():
        crop_other_bev = multi_crop(bev, ppm, crop * 2)
    other_embd = conv_emb(core.lidar_conv_emb,
                          multi_crop(features, ppm / 2, crop))
    other_cast_locs = cast(core, other_embd, T)
    other_cast_cmds = cast_cmd_pred(core, other_embd)

    ego_fut = transform_points(ego_locs[:, 1:] - eloc_jit[:, None],
                               -eori_jit)
    nxps_j = transform_points(nxps[:, None] - eloc_jit[:, None],
                              -eori_jit)[:, 0]
    crop_ego_feat = crop_feature(features, eloc_jit, eori_jit,
                                 pixels_per_meter=ppm / 2, crop_size=crop,
                                 offset_y=cfg.y_offset)
    with torch.no_grad():   # the frozen teacher
        other_bev_embd = conv_emb(teacher.bev_conv_emb, crop_other_bev)
        other_cast_locs_expert = cast(teacher, other_bev_embd, T)
        other_cast_cmds_expert = cast_cmd_pred(teacher, other_bev_embd)
        crop_ego_bev = crop_feature(bev, eloc_jit, eori_jit,
                                    pixels_per_meter=ppm,
                                    crop_size=crop * 2,
                                    offset_y=cfg.y_offset)
        ego_bev_embd = conv_emb(teacher.bev_conv_emb, crop_ego_bev)
        ego_cast_locs_expert = cast(teacher, ego_bev_embd, T)
        ego_plan_locs_expert = plan(
            teacher, ego_bev_embd, nxps_j, ego_cast_locs_expert, num_plan=T,
            num_plan_iter=I, pixels_per_meter=ppm, crop_size=crop * 2)
    ego_embd = conv_emb(core.lidar_conv_emb, crop_ego_feat)
    ego_cast_locs = cast(core, ego_embd, T)
    ego_plan_locs = plan(core, ego_embd, nxps_j, ego_cast_locs, num_plan=T,
                         num_plan_iter=I, pixels_per_meter=ppm,
                         crop_size=crop * 2)
    C = cfg.num_cmds
    return UniPlannerOutputs(
        other_locs=other_locs,
        other_cast_locs=other_cast_locs.reshape(B, K, C, T, 2),
        other_cast_cmds=other_cast_cmds.reshape(B, K, C),
        other_cast_locs_expert=other_cast_locs_expert.reshape(B, K, C, T, 2),
        other_cast_cmds_expert=other_cast_cmds_expert.reshape(B, K, C),
        ego_locs=ego_fut,
        ego_plan_locs=ego_plan_locs,
        ego_cast_locs=ego_cast_locs,
        ego_cast_cmds=cast_cmd_pred(core, ego_embd),
        ego_cast_locs_expert=ego_cast_locs_expert,
        ego_plan_locs_expert=ego_plan_locs_expert,
        car_valid=car_valid,
    )
