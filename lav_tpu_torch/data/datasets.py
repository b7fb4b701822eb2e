"""Staged datasets over episode stores, emitting fixed-shape numpy dicts.

Re-implements the reference dataset family
(LAV's lav/utils/datasets/*.py) against the abstract Episode
store, with every output already padded/masked to static shapes so batches
feed the jitted train steps directly:

  bev                BEVDataset              (bev_dataset.py:9-72)
  temporal_bev       TemporalBEVDataset      (temporal_bev_dataset.py:8-115)
  seg                SegmentationDataset     (seg_dataset.py:6-31)
  bra                BrakePredictionDataset  (bra_dataset.py:6-40)
  lidar              LiDARDataset            (lidar_dataset.py:7-90)
  lidar_painted      LiDARPaintedDataset     (lidar_painted_dataset.py:7-92)
  temporal_lidar_painted TemporalLiDARPaintedDataset (temporal_*:11-179)
  point_paint        PointPaintDataset       (point_paint_dataset.py)

Sign convention preserved from the reference: planning targets are negated
world->model (`-ego_locs, -nxp, -padded_locs`).
"""

from __future__ import annotations

import glob
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from lav_tpu_torch.config import LAVConfig
from lav_tpu_torch.data.augment import Augmenter
from lav_tpu_torch.data.store import Episode, open_episode
from lav_tpu_torch.data.transforms import (
    detections_to_heatmap_np,
    ego_hull_filter,
    filter_sem,
    move_lidar_points_np,
    rotate_image,
    rotate_lidar_np,
    rotate_points_np,
    transform_ego,
)
from lav_tpu_torch.ops.painting import CameraRig

TRAIN_TOWNS = ("Town01", "Town03", "Town04", "Town06")
MARGIN = 32


class BaseDataset:
    """Flat frame index over a list of episodes (reference BasicDataset
    scan, basic_dataset.py:33-74: skip the last num_plan frames)."""

    def __init__(self, cfg: LAVConfig, episodes: Sequence[Episode],
                 seed: int = 2021):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.frames: List = []  # (episode, index)
        for ep in episodes:
            if self.rng.random() > cfg.percentage_data:
                continue
            if not cfg.all_towns and ep.town not in TRAIN_TOWNS:
                continue
            n = len(ep)
            for i in range(n - cfg.num_plan):
                self.frames.append((ep, i))

    @classmethod
    def from_data_dir(cls, cfg: LAVConfig, **kw):
        eps = [open_episode(p) for p in sorted(glob.glob(f"{cfg.data_dir}/**"))]
        return cls(cfg, eps, **kw)

    def __len__(self):
        return len(self.frames)

    # -- shared helpers -----------------------------------------------------

    def _actors(self, ep, index, vehicle_radius=None):
        cfg = self.cfg
        ego_locs, ego_oris, _, locs, oris, _, typs = ep.gather_actors(
            index, cfg.num_plan,
            max_pedestrian_radius=cfg.max_pedestrian_radius,
            max_vehicle_radius=vehicle_radius or cfg.max_vehicle_radius,
        )
        return ego_locs, ego_oris, locs, oris, typs

    def _actors_full(self, ep, index, vehicle_radius=None):
        cfg = self.cfg
        return ep.gather_actors(
            index, cfg.num_plan,
            max_pedestrian_radius=cfg.max_pedestrian_radius,
            max_vehicle_radius=vehicle_radius or cfg.max_vehicle_radius,
        )

    def _pad_objs(self, locs, oris, typs):
        cfg = self.cfg
        n = min(len(locs), cfg.max_objs)
        p_locs = np.zeros((cfg.max_objs, cfg.num_plan + 1, 2), np.float32)
        p_oris = np.zeros((cfg.max_objs,), np.float32)
        p_typs = np.full((cfg.max_objs,), -1, np.int32)  # -1 = padding
        p_locs[:n] = locs[:n]
        p_oris[:n] = oris[:n, 0]
        p_typs[:n] = typs[:n, 0]
        return p_locs, p_oris, p_typs, n

    def _plan_targets(self, ep, index):
        cmd = int(ep.access("cmd", index, 1, np.uint8).reshape(-1)[0])
        bra = int(ep.access("bra", index, 1, np.uint8).reshape(-1)[0])
        nxp = ep.access("nxp", index, 1).reshape(2).astype(np.float64)
        return cmd, bra, nxp


class BEVDataset(BaseDataset):
    """Privileged-planner samples (v1): 5-channel BEV + plan targets."""

    bev_channels = (0, 1, 2, 9, 10)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        ep, index = self.frames[idx]
        ego_locs, ego_oris, locs, oris, typs = self._actors(ep, index)
        ego_locs, locs, oris = transform_ego(ego_locs, locs, oris, ego_oris[0])

        offset = int(np.clip(
            int((self.rng.random() * 2 - 1) * cfg.x_jitter), -MARGIN, MARGIN
        ))
        angle = (self.rng.random() * 2 - 1) * cfg.angle_jitter

        H, W = cfg.ny, cfg.nx
        bev = ep.load_bev(index, channels=self.bev_channels)
        bev = rotate_image(bev, angle, center=(W // 2, int(H + cfg.min_x * cfg.pixels_per_meter)))
        bev = (bev > 0).astype(np.float32)
        bev = np.pad(bev, [[MARGIN, MARGIN], [MARGIN, MARGIN], [0, 0]])
        bev = bev[MARGIN:MARGIN + H, MARGIN + offset:MARGIN + offset + W]

        cmd, bra, nxp = self._plan_targets(ep, index)
        shift = np.array([offset / cfg.pixels_per_meter, 0.0])
        # reference quirk (bev_dataset.py:46-55): ego rotates about the OLD
        # center; nxp/locs rotate about the ALREADY-SHIFTED ego center
        old_center = ego_locs[0].copy()
        ego_locs = rotate_points_np(ego_locs, -angle, old_center) + shift
        new_center = ego_locs[0]
        nxp = rotate_points_np(nxp, -angle, new_center) + shift
        locs = rotate_points_np(locs, -angle, new_center) + shift
        oris[1:] -= math.radians(angle)

        p_locs, p_oris, p_typs, _ = self._pad_objs(locs, oris, typs)
        return dict(
            bev=bev.astype(np.float32),
            ego_locs=(-ego_locs).astype(np.float32),
            cmds=np.int32(cmd),
            nxps=(-nxp).astype(np.float32),
            bras=np.int32(bra),
            locs=(-p_locs).astype(np.float32),
            oris=p_oris,
            typs=p_typs,
        )


class TemporalBEVDataset(BEVDataset):
    """v2 teacher samples: base [0,9,10] + per-history-frame [1,2] channels
    re-registered into the current ego frame."""

    def _bev_channels(self, ep, index, channels, *, angle=0.0, angle_offset=0.0,
                      y_offset=0, loc=(0, 0)):
        cfg = self.cfg
        H, W = cfg.ny, cfg.nx
        dx, dy = int(loc[0]), int(loc[1])
        bev = ep.load_bev(index, channels=channels)
        center = (W // 2, int(H + cfg.min_x * cfg.pixels_per_meter))
        bev = rotate_image(bev, -math.degrees(angle), center=center)
        bev = np.pad(bev, [[MARGIN, MARGIN], [MARGIN, MARGIN], [0, 0]])
        bev = bev[dx + MARGIN:dx + MARGIN + H,
                  dy + MARGIN + y_offset:dy + MARGIN + y_offset + W]
        bev = rotate_image(bev, angle_offset, center=center)
        return (bev > 0).astype(np.float32)

    def __getitem__(self, idx):
        cfg = self.cfg
        ep, index = self.frames[idx]
        ego_locs, ego_oris, locs, oris, typs = self._actors(ep, index)
        ego_locs, locs, oris = transform_ego(ego_locs, locs, oris, ego_oris[0])

        offset = int(np.clip(
            int((self.rng.random() * 2 - 1) * cfg.x_jitter), -MARGIN, MARGIN
        ))
        angle = (self.rng.random() * 2 - 1) * cfg.angle_jitter

        H, W = cfg.ny, cfg.nx
        C = 3 + 2 * (cfg.num_frame_stack + 1)
        bev = np.zeros((H, W, C), np.float32)
        bev[..., :3] = self._bev_channels(
            ep, index, [0, 9, 10], angle_offset=angle, y_offset=offset
        )

        ego_loc0, ego_ori0 = None, None
        for t, i in enumerate(reversed(range(index - cfg.num_frame_stack, index + 1))):
            if i < 0:
                continue
            e_locs, e_oris, *_ = self._actors_full(ep, i)
            # gather_actors returns ego first; use its pose at frame i
            ego_loc, ego_ori = e_locs, e_oris
            if i == index:
                ego_loc0, ego_ori0 = ego_loc[0], ego_ori[0]
            c0, s0 = math.cos(ego_ori0), math.sin(ego_ori0)
            d = (ego_loc[0] - ego_loc0)
            dloc = np.array([d[0] * c0 + d[1] * s0,
                             -d[0] * s0 + d[1] * c0]) * cfg.pixels_per_meter
            bev[..., 3 + 2 * t:3 + 2 * (t + 1)] = self._bev_channels(
                ep, i, [1, 2], angle=ego_ori[0] - ego_ori0,
                angle_offset=angle, y_offset=offset, loc=dloc,
            )

        cmd, bra, nxp = self._plan_targets(ep, index)
        shift = np.array([offset / cfg.pixels_per_meter, 0.0])
        # reference order (temporal_bev_dataset.py:72-78): locs about the
        # OLD center, then ego, then nxp about the SHIFTED center
        old_center = ego_locs[0].copy()
        locs = rotate_points_np(locs, -angle, old_center) + shift
        oris[1:] -= math.radians(angle)
        ego_locs = rotate_points_np(ego_locs, -angle, old_center) + shift
        nxp = rotate_points_np(nxp, -angle, ego_locs[0]) + shift

        p_locs, p_oris, p_typs, _ = self._pad_objs(locs, oris, typs)
        return dict(
            bev=bev,
            ego_locs=(-ego_locs).astype(np.float32),
            cmds=np.int32(cmd),
            nxps=(-nxp).astype(np.float32),
            bras=np.int32(bra),
            locs=(-p_locs).astype(np.float32),
            oris=p_oris,
            typs=p_typs,
        )


class SegmentationDataset(BaseDataset):
    """Per-camera samples: len = num_frames * num_cameras."""

    def __init__(self, *args, augment_prob: float = 0.5, **kw):
        super().__init__(*args, **kw)
        self.augmenter = Augmenter(augment_prob)

    def __len__(self):
        return len(self.frames) * len(self.cfg.camera_yaws)

    def __getitem__(self, idx):
        ncams = len(self.cfg.camera_yaws)
        ep, index = self.frames[idx // ncams]
        cam = idx % ncams
        rgb = ep.load_img(f"rgb_{cam}", index)
        sem = ep.load_img(f"sem_{cam}", index)
        rgb = self.augmenter(rgb)
        sem = filter_sem(sem, self.cfg.seg_channels)
        return dict(rgb=rgb.astype(np.float32), sem=sem.astype(np.int32))


class BrakePredictionDataset(BaseDataset):
    """3 center cams side-by-side + cropped telephoto; labels [4,10,18]."""

    bra_sem_labels = (4, 10, 18)

    def __init__(self, *args, augment_prob: float = 0.5, **kw):
        super().__init__(*args, **kw)
        self.augmenter = Augmenter(augment_prob)

    def __getitem__(self, idx):
        cfg = self.cfg
        ep, index = self.frames[idx]
        mid = len(cfg.camera_yaws) // 2
        rgbs = [ep.load_img(f"rgb_{c}", index) for c in (mid - 1, mid, mid + 1)]
        sems = [ep.load_img(f"sem_{c}", index) for c in (mid - 1, mid, mid + 1)]
        tel_rgb = ep.load_img("tel_rgb", index)
        tel_sem = ep.load_img("tel_sem", index)
        bra = int(ep.access("bra", index, 1, np.uint8).reshape(-1)[0])

        rgb = self.augmenter(np.concatenate(rgbs, axis=1))
        crop = min(cfg.crop_tel_bottom, tel_rgb.shape[0] - 1)
        tel_rgb = self.augmenter(tel_rgb[:-crop])
        sem = filter_sem(np.concatenate(sems, axis=1), self.bra_sem_labels)
        tel_sem = filter_sem(tel_sem, self.bra_sem_labels)[:-crop]
        return dict(
            rgb=rgb.astype(np.float32), tel_rgb=tel_rgb.astype(np.float32),
            sem=sem.astype(np.int32), tel_sem=tel_sem.astype(np.int32),
            bra=np.int32(bra),
        )


class LiDARDataset(BaseDataset):
    """Single-sweep perception+planning samples (v1, unpainted)."""

    painted = False

    def _load_sweep(self, ep, index):
        lidar = ep.access("lidar", index, 1).reshape(-1, 4).astype(np.float64)
        if self.painted:
            sem = ep.access("lidar_sem", index, 1).reshape(
                -1, len(self.cfg.seg_channels)
            ).astype(np.float64)
            return ego_hull_filter(lidar, sem)
        return (ego_hull_filter(lidar),)

    def _paint_mask(self, lidar):
        """Camera-frustum visibility re-mask after rotation jitter
        (lidar_painted_dataset.py:56-58): paint with all-ones maps."""
        cfg = self.cfg
        rigs = [CameraRig.build(
            yaw, lidar_xyz=(0, 0, cfg.camera_z),
            cam_xyz=(cfg.camera_x, 0, cfg.camera_z), rgb_h=288, rgb_w=256,
            fov=64,
        ) for yaw in cfg.camera_yaws[1:-1]]
        mask = np.zeros((len(lidar), 1))
        for rig in rigs:
            p = lidar[:, :3] + rig.trans
            cam = p @ rig.rot.T
            img = np.stack([cam[:, 1], -cam[:, 2], cam[:, 0]], -1) @ rig.K.T
            z = img[:, 2]
            u = (img[:, 0] / (1e-5 + z)).astype(int)
            v = (img[:, 1] / (1e-5 + z)).astype(int)
            ok = (z.astype(int) >= 0) & (u >= 0) & (u < rig.width) & \
                 (v >= 0) & (v < rig.height)
            mask[ok] = 1.0
        return mask

    def __getitem__(self, idx):
        cfg = self.cfg
        ep, index = self.frames[idx]
        sweep = self._load_sweep(ep, index)
        lidar_xyzr = sweep[0]

        ego_locs, ego_oris, locs, oris, typs = self._actors(ep, index)
        ego_locs, locs, oris = transform_ego(ego_locs, locs, oris, ego_oris[0])

        angle = (self.rng.random() * 2 - 1) * cfg.angle_jitter
        cmd, bra, nxp = self._plan_targets(ep, index)

        H, W = cfg.ny, cfg.nx
        bev = ep.load_bev(index, channels=[0, 1, 2, 9, 10])
        bev = rotate_image(
            bev, angle, center=(W // 2, int(H + cfg.min_x * cfg.pixels_per_meter))
        )
        bev = (bev > 0).astype(np.float32)

        lidar_xyzr = rotate_lidar_np(lidar_xyzr, -angle)
        center = ego_locs[0]
        ego_locs = rotate_points_np(ego_locs, -angle, center)
        nxp = rotate_points_np(nxp, -angle, center)
        locs = rotate_points_np(locs, -angle, center)
        oris[1:] -= math.radians(angle)

        if self.painted:
            painted = sweep[1] * self._paint_mask(lidar_xyzr)
            feat = np.concatenate([lidar_xyzr, painted], axis=-1)
        else:
            feat = lidar_xyzr

        _, _, ego_bbox, _, _, bbox_all, _ = self._actors_full(ep, index)
        bbox0 = np.stack([bbox_all[i][0] for i in range(len(bbox_all))]) \
            if len(bbox_all) else np.zeros((0, 2))
        heatmaps, sizemaps, orimaps = detections_to_heatmap_np(
            locs[:, 0], oris[:, 0], bbox0, typs[:, 0],
            h=H, w=W, pixels_per_meter=cfg.pixels_per_meter,
            min_x=cfg.min_x, min_y=cfg.min_y, max_y=cfg.max_y,
        )

        p_locs, p_oris, p_typs, _ = self._pad_objs(locs, oris, typs)

        perm = self.rng.permutation(len(feat))
        feat = feat[perm]
        n = min(cfg.max_lidar_points, len(feat))
        padded = np.zeros((cfg.max_lidar_points, feat.shape[-1]), np.float32)
        padded[:n] = feat[:n]
        valid = np.zeros((cfg.max_lidar_points,), bool)
        valid[:n] = True

        return dict(
            lidar=padded, lidar_valid=valid,
            heatmaps=heatmaps, sizemaps=sizemaps, orimaps=orimaps,
            bev=bev,
            ego_locs=(-ego_locs).astype(np.float32),
            cmds=np.int32(cmd),
            nxps=(-nxp).astype(np.float32),
            bras=np.int32(bra),
            locs=(-p_locs).astype(np.float32),
            oris=p_oris,
            typs=p_typs,
        )


class LiDARPaintedDataset(LiDARDataset):
    painted = True


class TemporalLiDARPaintedDataset(LiDARPaintedDataset):
    """v2 samples: num_frame_stack+1 painted sweeps, each ego-motion
    compensated with per-frame pose jitter, one-hot age channels."""

    def __getitem__(self, idx):
        cfg = self.cfg
        ep, index = self.frames[idx]
        angle = (self.rng.random() * 2 - 1) * cfg.angle_jitter
        n_sem = len(cfg.seg_channels)
        n_stack = cfg.num_frame_stack + 1

        sweeps = []
        ego_loc0, ego_ori0 = None, None
        for t, i in enumerate(reversed(range(index - cfg.num_frame_stack, index + 1))):
            if i < 0:
                continue
            lidar_xyzr, painted = self._load_sweep(ep, i)
            e_locs, e_oris, *_ = self._actors_full(ep, i)
            ego_loc, ego_ori = e_locs[0], e_oris[0]
            if i == index:
                ego_loc0, ego_ori0 = ego_loc, ego_ori
                loc_jit = np.zeros(2)
                ori_jit = 0.0
            else:
                loc_jit = self.rng.uniform(
                    -cfg.stack_loc_jitter, cfg.stack_loc_jitter, 2
                )
                ori_jit = self.rng.uniform(
                    -cfg.stack_ori_jitter, cfg.stack_ori_jitter
                )
            lidar_xyzr = rotate_lidar_np(lidar_xyzr, -angle)
            painted = painted * self._paint_mask(lidar_xyzr)
            lidar_xyzr = move_lidar_points_np(
                lidar_xyzr, ego_loc - ego_loc0 + loc_jit, ego_ori0,
                ego_ori + ori_jit,
            )
            feat = np.zeros((len(lidar_xyzr), 4 + n_sem + n_stack), np.float32)
            feat[:, :4] = lidar_xyzr
            feat[:, 4:4 + n_sem] = painted
            feat[:, 4 + n_sem + t] = 1.0
            sweeps.append(feat)

        all_pts = np.concatenate(sweeps)
        perm = self.rng.permutation(len(all_pts))[:cfg.max_lidar_points]
        all_pts = all_pts[perm]
        n = len(all_pts)
        padded = np.zeros((cfg.max_lidar_points, all_pts.shape[-1]), np.float32)
        padded[:n] = all_pts
        valid = np.zeros((cfg.max_lidar_points,), bool)
        valid[:n] = True

        cmd, bra, nxp = self._plan_targets(ep, index)

        # detection targets: the wider vehicle radius
        ego_locs, ego_oris, locs, oris, typs = self._actors(ep, index)
        ego_locs, locs, oris = transform_ego(ego_locs, locs, oris, ego_oris[0])
        locs = rotate_points_np(locs, -angle, ego_locs[0])
        oris[1:] -= math.radians(angle)
        _, _, _, _, _, bbox_all, _ = self._actors_full(ep, index)
        bbox0 = np.stack([bbox_all[i][0] for i in range(len(bbox_all))])
        H, W = cfg.ny, cfg.nx
        heatmaps, sizemaps, orimaps = detections_to_heatmap_np(
            locs[:, 0], oris[:, 0], bbox0, typs[:, 0],
            h=H, w=W, pixels_per_meter=cfg.pixels_per_meter,
            min_x=cfg.min_x, min_y=cfg.min_y, max_y=cfg.max_y,
        )

        # temporal BEV seg targets (reference temporal_*:105-136)
        tb = TemporalBEVDataset.__new__(TemporalBEVDataset)
        tb.cfg, tb.rng = cfg, self.rng
        bev = np.zeros((H, W, 3 + 2 * n_stack), np.float32)
        bev[..., :3] = TemporalBEVDataset._bev_channels(
            tb, ep, index, [0, 9, 10], angle_offset=angle
        )
        for t, i in enumerate(reversed(range(index - cfg.num_frame_stack, index + 1))):
            if i < 0:
                continue
            e_locs, e_oris, *_ = self._actors_full(ep, i)
            if i == index:
                bl0, bo0 = e_locs[0], e_oris[0]
            c0, s0 = math.cos(bo0), math.sin(bo0)
            d = e_locs[0] - bl0
            dloc = np.array([d[0] * c0 + d[1] * s0,
                             -d[0] * s0 + d[1] * c0]) * cfg.pixels_per_meter
            bev[..., 3 + 2 * t:3 + 2 * (t + 1)] = TemporalBEVDataset._bev_channels(
                tb, ep, i, [1, 2], angle=e_oris[0] - bo0,
                angle_offset=angle, loc=dloc,
            )

        # motion targets use the tighter vehicle radius (temporal_*:159-170)
        m_ego_locs, m_ego_oris, m_locs, m_oris, m_typs = self._actors(
            ep, index, vehicle_radius=cfg.max_mot_vehicle_radius or
            cfg.max_vehicle_radius,
        )
        m_ego_locs, m_locs, m_oris = transform_ego(
            m_ego_locs, m_locs, m_oris, m_ego_oris[0]
        )
        center = m_ego_locs[0]
        m_ego_locs = rotate_points_np(m_ego_locs, -angle, center)
        nxp = rotate_points_np(nxp, -angle, center)
        m_locs = rotate_points_np(m_locs, -angle, center)
        m_oris[1:] -= math.radians(angle)
        p_locs, p_oris, p_typs, _ = self._pad_objs(m_locs, m_oris, m_typs)

        return dict(
            lidar=padded, lidar_valid=valid,
            heatmaps=heatmaps, sizemaps=sizemaps, orimaps=orimaps,
            bev=bev,
            ego_locs=(-m_ego_locs).astype(np.float32),
            cmds=np.int32(cmd),
            nxps=(-nxp).astype(np.float32),
            bras=np.int32(bra),
            locs=(-p_locs).astype(np.float32),
            oris=p_oris,
            typs=p_typs,
        )


class PointPaintDataset(BaseDataset):
    """Read/write dataset for the offline painting pass
    (point_paint_dataset.py:13-46): raw lidar + all cams in, painted
    semantics committed back to the store."""

    def __getitem__(self, idx):
        ep, index = self.frames[idx]
        lidar = ep.access("lidar", index, 1).reshape(-1, 4)
        rgbs = np.stack([
            ep.load_img(f"rgb_{c}", index)
            for c in range(len(self.cfg.camera_yaws))
        ])
        return dict(lidar=lidar, rgbs=rgbs, idx=np.int64(idx))

    def commit(self, idx, painted: np.ndarray):
        ep, index = self.frames[idx]
        ep.store.put(
            f"lidar_sem_{index:05d}".encode(),
            painted.astype(np.float32).tobytes(),
        )


class RGBDataset(BaseDataset):
    """Camera-BC leftover in the reference (rgb_dataset.py, unused by any
    train script); kept for inventory parity."""

    def __getitem__(self, idx):
        cfg = self.cfg
        ep, index = self.frames[idx]
        mid = len(cfg.camera_yaws) // 2
        rgb = ep.load_img(f"rgb_{mid}", index)
        sem = filter_sem(ep.load_img(f"sem_{mid}", index), cfg.seg_channels)
        cmd, bra, nxp = self._plan_targets(ep, index)
        ego_locs, ego_oris, locs, oris, typs = self._actors(ep, index)
        ego_locs, locs, oris = transform_ego(ego_locs, locs, oris, ego_oris[0])
        return dict(
            rgb=rgb.astype(np.float32), sem=sem.astype(np.int32),
            ego_locs=(-ego_locs).astype(np.float32),
            cmds=np.int32(cmd), nxps=(-nxp).astype(np.float32),
            bras=np.int32(bra),
        )


_DATASETS = {
    "bev": BEVDataset,
    "temporal_bev": TemporalBEVDataset,
    "seg": SegmentationDataset,
    "bra": BrakePredictionDataset,
    "lidar": LiDARDataset,
    "lidar_painted": LiDARPaintedDataset,
    "temporal_lidar_painted": TemporalLiDARPaintedDataset,
    "point_paint": PointPaintDataset,
    "rgb": RGBDataset,
}


def get_dataset(name: str, cfg: LAVConfig, episodes=None, **kw):
    """Factory (reference datasets/__init__.py:12-40)."""
    cls = _DATASETS[name]
    if episodes is None:
        return cls.from_data_dir(cfg, **kw)
    return cls(cfg, episodes, **kw)
