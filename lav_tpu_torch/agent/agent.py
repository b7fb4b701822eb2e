"""The closed-loop driving agent tick, batched over egos (counterpart of
`lav_tpu/agent/agent.py::build_agent`).

One tick: camera segmentation, point painting, the ring-buffer temporal
lidar stack, the brake net, PointPillars with its backbone and heads,
masked peak decode, UniPlanner inference, EKF, PID and every safety
override.  lav_tpu vmaps a single-ego step; here the ego axis E is
written out: every state and observation tensor leads with it, and the
per-ego `lax.cond` / ring-buffer writes become per-ego `torch.where` and
indexed writes at each ego's own slot.  `step` returns a new state and
leaves its input untouched.  Stages carry `torch.profiler` labels
(`agent/seg`, `agent/paint`, `agent/stack`, `agent/brake`, `agent/lidar`,
`agent/decode`, `agent/planner`); without a profiler they record nothing.

`compute_dtype` (default f32) is lav_tpu's: the camera nets, the painted
features, the lidar model and the planner crops and ResNet run in it,
with lav_tpu's casts (`agent.py:107,213-220,291-292,308`): the seg
softmax, the brake output, the head maps, the GRU rollouts, geometry, EKF
and PID stay f32.  The stacked points enter the lidar model in the
compute dtype, so pillar ids come from bf16 coordinates under bf16.
`use_pallas` picks lav_tpu's pillar route (ops/pillar.py).  The models
may carry int8 convs (`nn/quant.py`, `agent/setup.py`).

The diagnostic `skip` stages and the `det_override` option of lav_tpu's
agent are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from lav_tpu_torch.agent.control import pid_control, plan_collide
from lav_tpu_torch.agent.ekf import (
    EKFState, ekf_init_state, ekf_make, ekf_predict_update, ekf_select,
)
from lav_tpu_torch.agent.pid import pid_init, pid_make
from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.core.geometry import apply_rot2, move_lidar_points
from lav_tpu_torch.models.lidar import LidarModel
from lav_tpu_torch.models.planner import UniPlanner, uniplanner_infer
from lav_tpu_torch.models.rgb import BrakeModel, SegModel
from lav_tpu_torch.ops.painting import CameraRig, point_painting
from lav_tpu_torch.ops.peak import det_inference
from lav_tpu_torch.utils.device import resolve_device

NUM_REPEAT = 4
GAP = NUM_REPEAT + 1  # every 5th frame enters the temporal stack


class AgentState(NamedTuple):
    """Per-ego mutable state; every field leads with the ego axis E."""
    ekf: EKFState
    lidar_buf: torch.Tensor       # (E, F, Pb, Df) fused painted sweeps
    lidar_valid: torch.Tensor     # (E, F, Pb) bool
    locs_buf: torch.Tensor        # (E, F, 2) EKF position of each sweep
    oris_buf: torch.Tensor        # (E, F)
    buf_ptr: torch.Tensor         # (E,) int32 next write slot
    buf_count: torch.Tensor       # (E,) int32 sweeps pushed (saturating)
    prev_lidar: torch.Tensor      # (E, P, 4) previous raw sweep
    prev_valid: torch.Tensor      # (E, P) bool
    turn_window: torch.Tensor     # (E, turn_n)
    speed_window: torch.Tensor    # (E, speed_n)
    stop_counter: torch.Tensor    # (E,) int32
    force_move: torch.Tensor      # (E,) int32
    lane_change_counter: torch.Tensor  # (E,) int32
    lane_changed: torch.Tensor    # (E,) int32, -1 = none
    num_frames: torch.Tensor      # (E,) int32


class Control(NamedTuple):
    steer: torch.Tensor      # (E,)
    throttle: torch.Tensor   # (E,)
    brake: torch.Tensor      # (E,)


class AgentModels(nn.Module):
    """The agent's four nets under lav_tpu's params keys."""

    def __init__(self, cfg: LAVConfig, brake_version: int = 2, gen=None):
        super().__init__()
        self.lidar_model = LidarModel(
            cfg.num_input, cfg.num_features, min_x=cfg.min_x,
            max_x=cfg.max_x, min_y=cfg.min_y, max_y=cfg.max_y,
            pixels_per_meter=cfg.pixels_per_meter, gen=gen)
        self.uniplanner = UniPlanner(cfg, gen=gen)
        self.seg_model = SegModel(len(cfg.seg_channels), gen=gen)
        self.bra_model = BrakeModel(brake_version, gen=gen)


def _per_cmd(val, num_cmds: int):
    arr = np.asarray(val, dtype=np.float32)
    if arr.ndim == 0:
        arr = np.full((num_cmds,), float(arr), np.float32)
    return arr


def _ego_hull_mask(pts):
    """Drop returns from the ego vehicle body."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    hull = (x > -2.4) & (x < 0) & (y > -0.8) & (y < 0.8) & (z > -1.5) & (
        z < -1)
    return ~hull


def build_agent(cfg: LAVConfig, *, num_ego: int = 1, max_points: int = 0,
                camera_yaws=(-60, 0, 60), rgb_hw=(288, 256), cam_fov=64,
                compute_dtype=None, use_pallas: bool = False, device=None):
    """Returns (init_state, step) for `num_ego` egos on `device` (default
    `cuda`; raises if no card is present and the CPU was not asked for).

    step(models, state, obs) -> (Control, AgentState, aux); models is an
    `AgentModels` on the same device.  obs per tick, each leading with E:
      lidar (E, P, 4) padded raw sweep, lidar_valid (E, P) bool,
      rgbs (E, num_cams, H, W, 3) 0-255 floats, tel_rgb (E, Ht, Wt, 3),
      gps (E, 2) lat/lon, compass (E,) rad, speed (E,) m/s,
      cmd (E,) int model command, target (E, 2) world-frame goal vector.
    """
    dev = resolve_device(device)
    cdt = compute_dtype or torch.float32
    E = num_ego
    num_stack = cfg.num_frame_stack + 1
    num_keep = num_stack * GAP if cfg.num_frame_stack > 0 else 1
    P = max_points or (cfg.max_lidar_points // max(num_stack, 2))
    Pb = 2 * P  # fused = current + previous sweep
    n_sem = len(cfg.seg_channels)
    Df = 4 + n_sem
    ekf_consts = ekf_make(cos0=1.0, freq=cfg.fps, device=dev)
    rigs = tuple(
        CameraRig.build(yaw, lidar_xyz=(0, 0, cfg.camera_z),
                        cam_xyz=(cfg.camera_x, 0, cfg.camera_z),
                        rgb_h=rgb_hw[0], rgb_w=rgb_hw[1], fov=cam_fov)
        for yaw in camera_yaws)
    ctl = dict(
        turn_pid=pid_make(cfg.turn_KP, cfg.turn_KI, cfg.turn_KD, cfg.turn_n),
        speed_pid=pid_make(cfg.speed_KP, cfg.speed_KI, cfg.speed_KD,
                           cfg.speed_n),
        aim_point=torch.as_tensor(_per_cmd(cfg.aim_point, cfg.num_cmds),
                                  device=dev).long(),
        speed_ratio=torch.as_tensor(_per_cmd(cfg.speed_ratio, cfg.num_cmds),
                                    device=dev),
        pixels_per_meter=float(cfg.pixels_per_meter),
        brake_speed=cfg.brake_speed,
        clip_delta=cfg.clip_delta,
        max_throttle=cfg.max_throttle,
    )
    H, W = cfg.ny, cfg.nx
    ego_px = (W / 2.0, H / 2.0 + cfg.y_offset * H / 2.0)

    def zeros_i32():
        return torch.zeros((E,), dtype=torch.int32, device=dev)

    def init_state() -> AgentState:
        return AgentState(
            ekf=ekf_init_state(E, dev),
            lidar_buf=torch.zeros((E, num_keep, Pb, Df), device=dev),
            lidar_valid=torch.zeros((E, num_keep, Pb), dtype=torch.bool,
                                    device=dev),
            locs_buf=torch.zeros((E, num_keep, 2), device=dev),
            oris_buf=torch.zeros((E, num_keep), device=dev),
            buf_ptr=zeros_i32(),
            buf_count=zeros_i32(),
            prev_lidar=torch.zeros((E, P, 4), device=dev),
            prev_valid=torch.zeros((E, P), dtype=torch.bool, device=dev),
            turn_window=pid_init(E, cfg.turn_n, dev),
            speed_window=pid_init(E, cfg.speed_n, dev),
            stop_counter=zeros_i32(),
            force_move=zeros_i32(),
            lane_change_counter=zeros_i32(),
            lane_changed=torch.full((E,), -1, dtype=torch.int32, device=dev),
            num_frames=zeros_i32(),
        )

    def stacked_lidar(lidar_buf, lidar_valid, locs_buf, oris_buf, ptr, count,
                      loc0, ori0):
        """Re-register `num_stack` buffered sweeps into the current ego
        frame, tagged with one-hot age channels."""
        ar = torch.arange(E, device=dev)
        sweeps, valids = [], []
        for i in range(num_stack):
            idx = torch.remainder(ptr.long() - 1 - i * GAP, num_keep)
            sweep = lidar_buf[ar, idx]                    # (E, Pb, Df)
            svalid = lidar_valid[ar, idx] & ((i * GAP) < count)[:, None]
            xyz = move_lidar_points(sweep[..., :3], locs_buf[ar, idx] - loc0,
                                    ori0, oris_buf[ar, idx])
            cols = [xyz, sweep[..., 3:]]
            if cfg.num_frame_stack > 0:
                age = torch.zeros((E, Pb, num_stack), device=dev)
                age[..., i] = 1.0
                cols.append(age)
            sweeps.append(torch.cat(cols, dim=-1))
            valids.append(svalid)
        return torch.cat(sweeps, dim=1), torch.cat(valids, dim=1)

    @torch.no_grad()
    def step(models: AgentModels, state: AgentState, obs
             ) -> Tuple[Control, AgentState, Dict]:
        ar = torch.arange(E, device=dev)
        num_frames = state.num_frames + 1
        compass = torch.where(torch.isnan(obs["compass"]),
                              torch.zeros_like(obs["compass"]),
                              obs["compass"])
        ori_meas = compass - math.pi / 2
        spd = obs["speed"]
        gps = obs["gps"]

        # EKF: the first tick latches the measurement; afterwards the
        # filter ran its predict-update at the end of the previous tick
        latched = ekf_predict_update(ekf_consts, state.ekf, spd,
                                     torch.zeros_like(spd), gps[:, 0],
                                     gps[:, 1], ori_meas)
        ekf0 = ekf_select(state.ekf.initialized, state.ekf, latched)
        loc, ori = ekf0.x[:, :2], ekf0.x[:, 2]
        stop_counter = torch.where(spd < 0.1, state.stop_counter + 1,
                                   torch.zeros_like(state.stop_counter))

        # ---- lidar fuse + paint ----------------------------------------
        raw = obs["lidar"]
        raw_valid = obs["lidar_valid"] & _ego_hull_mask(raw)
        fused = torch.cat([raw, state.prev_lidar], dim=1)        # (E, Pb, 4)
        fused_valid = torch.cat(
            [raw_valid, state.prev_valid & _ego_hull_mask(state.prev_lidar)],
            dim=1)
        rgbs = obs["rgbs"]
        ncams = rgbs.shape[1]
        with record_function("agent/seg"):
            seg_logits = models.seg_model(
                rgbs.reshape(E * ncams, *rgbs.shape[2:]).to(cdt))
            sem_prob = torch.softmax(seg_logits.float(), dim=-1)
            pred_sem = (sem_prob[..., 1:] * (1.0 - sem_prob[..., :1])
                        ).to(cdt).reshape(E, ncams, *sem_prob.shape[1:3],
                                          n_sem)
        with record_function("agent/paint"):
            painted = point_painting(fused[..., :3], pred_sem, rigs,
                                     valid=fused_valid)
        fused_painted = torch.cat([fused, painted.float()], dim=-1)

        # ---- ring buffer push (skipped on the very first frame) ---------
        push = num_frames >= 2
        ptr = state.buf_ptr.long()
        lidar_buf = state.lidar_buf.clone()
        lidar_valid = state.lidar_valid.clone()
        locs_buf = state.locs_buf.clone()
        oris_buf = state.oris_buf.clone()
        lidar_buf[ar, ptr] = torch.where(push[:, None, None], fused_painted,
                                         lidar_buf[ar, ptr])
        lidar_valid[ar, ptr] = torch.where(push[:, None], fused_valid,
                                           lidar_valid[ar, ptr])
        locs_buf[ar, ptr] = torch.where(push[:, None], loc, locs_buf[ar, ptr])
        oris_buf[ar, ptr] = torch.where(push, ori, oris_buf[ar, ptr])
        new_ptr = torch.where(push, torch.remainder(state.buf_ptr + 1,
                                                    num_keep), state.buf_ptr)
        new_count = torch.where(
            push, torch.clamp(state.buf_count + 1, max=num_keep),
            state.buf_count)
        with record_function("agent/stack"):
            stacked, stacked_valid = stacked_lidar(
                lidar_buf, lidar_valid, locs_buf, oris_buf, new_ptr,
                new_count, loc, ori)

        # ---- command + lane-change suppression --------------------------
        cmd = obs["cmd"].to(torch.int32)
        is_lc = (cmd == 4) | (cmd == 5)
        zero_i = torch.zeros_like(cmd)
        lcc = torch.where(
            is_lc & (state.lane_changed != -1) & (cmd != state.lane_changed),
            zero_i, state.lane_change_counter)
        lcc = torch.where(is_lc, lcc + 1, zero_i)
        lane_changed = torch.where(is_lc & (lcc > 300), cmd,
                                   torch.full_like(cmd, -1))
        cmd_eff = torch.where(cmd == lane_changed, torch.full_like(cmd, 3),
                              cmd)

        # target vector world -> ego: rotate by -compass + pi/2, negate
        theta = -compass + math.pi / 2
        tx, ty = apply_rot2(obs["target"][:, 0], obs["target"][:, 1],
                            torch.cos(theta), torch.sin(theta))
        nxp = torch.stack([-tx, -ty], dim=-1)

        # ---- brake net ---------------------------------------------------
        with record_function("agent/brake"):
            wide = torch.cat([rgbs[:, i] for i in range(ncams)], dim=2)
            pred_bra = models.bra_model(wide.to(cdt),
                                        obs["tel_rgb"].to(cdt)).float()

        # ---- perception + planning --------------------------------------
        with record_function("agent/lidar"):
            feats, hm, size, orim, bev = models.lidar_model(
                stacked.to(cdt), stacked_valid, use_pallas=use_pallas)
        with record_function("agent/decode"):
            dets = det_inference(
                torch.sigmoid(hm.float()), size.float(), orim.float(),
                pixels_per_meter=cfg.pixels_per_meter, max_det=cfg.max_det,
                min_score=cfg.det_min_score, ego_xy=ego_px,
                ego_exclusion_px=2.0)
            veh = {k: v[:, 1] for k, v in dets._asdict().items()}  # vehicles
        with record_function("agent/planner"):
            ego_plan_locs, ego_cast_cmd_locs, other_cast_locs, \
                other_cast_cmds, other_valid = uniplanner_infer(
                    models.uniplanner, cfg, feats, veh, cmd_eff, nxp)

        # lane-change commands drive on the raw cast
        lc_eff = ((cmd_eff == 4) | (cmd_eff == 5))[:, None, None]
        plan_wps = torch.where(lc_eff, ego_cast_cmd_locs, ego_plan_locs)

        # ---- control ------------------------------------------------------
        steer, throttle, brake_b, turn_w, speed_w = pid_control(
            ctl, state.turn_window, state.speed_window, plan_wps, spd,
            cmd_eff)
        zero_f = torch.zeros_like(steer)
        plan_nan = torch.isnan(plan_wps).flatten(1).any(dim=1)
        steer = torch.where(plan_nan, zero_f, steer)
        throttle = torch.where(plan_nan, zero_f, throttle)
        brake = torch.where(plan_nan, zero_f, brake_b.float())

        ekf1 = ekf_predict_update(ekf_consts, ekf0, spd, steer, gps[:, 0],
                                  gps[:, 1], ori_meas)

        # ---- overrides -----------------------------------------------------
        collide = plan_collide(
            plan_wps, other_cast_locs, other_cast_cmds, other_valid,
            pixels_per_meter=cfg.pixels_per_meter, cmd_thresh=cfg.cmd_thresh,
            brake_speed=cfg.brake_speed,
            dist_threshold_static=cfg.collide_dist_static,
            dist_threshold_moving=cfg.collide_dist_moving)
        one_f = torch.ones_like(steer)
        hard_brake = (pred_bra > cfg.brake_net_thresh) | collide
        throttle = torch.where(hard_brake, zero_f, throttle)
        brake = torch.where(hard_brake, one_f, brake)
        throttle = torch.where(spd * 3.6 > cfg.max_speed, zero_f, throttle)

        force_move = torch.where(stop_counter >= 600,
                                 torch.full_like(state.force_move, 20),
                                 state.force_move)
        throttle = torch.where(force_move > 0,
                               torch.clamp(throttle, min=0.4), throttle)
        brake = torch.where(force_move > 0, zero_f, brake)
        force_move = torch.clamp(force_move - 1, min=0)

        # first frame: no control (LAV's early return)
        first = num_frames <= 1
        steer = torch.where(first, zero_f, steer)
        throttle = torch.where(first, zero_f, throttle)
        brake = torch.where(first, zero_f, brake)

        new_state = AgentState(
            ekf=ekf1,
            lidar_buf=lidar_buf, lidar_valid=lidar_valid,
            locs_buf=locs_buf, oris_buf=oris_buf,
            buf_ptr=new_ptr, buf_count=new_count,
            prev_lidar=raw,
            prev_valid=obs["lidar_valid"],
            turn_window=turn_w,
            speed_window=speed_w,
            stop_counter=stop_counter,
            force_move=force_move,
            lane_change_counter=lcc,
            lane_changed=lane_changed,
            num_frames=num_frames,
        )
        aux = dict(
            pred_bra=pred_bra,
            plan_locs=plan_wps,
            dets=veh,
            other_cast_locs=other_cast_locs,
            other_cast_cmds=other_cast_cmds,
            other_valid=other_valid,
            bev=bev,
            collide=collide,
            nxp=nxp,
        )
        return Control(steer, throttle, brake), new_state, aux

    return init_state, step
