"""Typed configuration, a copy of `lav_tpu.config` for the PyTorch port.

The port keeps its own copy so that it imports nothing of `lav_tpu`.  Key
names match LAV's YAML configs (config.yaml, config_v2.yaml).  A frozen
dataclass: one typed source of truth shared by the models and the agent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class LAVConfig:
    # ---- global ----
    fps: int = 20
    crop_size: int = 96
    bev_embd_size: int = 96
    embd_size: int = 32
    imagenet_pretrained: bool = False
    log_wandb: bool = False

    # ---- planning shape ----
    num_plan: int = 10
    num_cmds: int = 6
    num_plan_iter: int = 5
    num_sample: int = 50

    # ---- loss weights / smoothing ----
    cmd_weight: float = 0.1
    cmd_smooth: float = 0.2
    cmd_thresh: float = 0.2
    kd_weight: float = 1.0
    other_weight: float = 0.5
    expert_weight: float = 0.5
    box_weight: float = 1.0
    ori_weight: float = 1.0
    seg_weight: float = 2.0
    perception_weight: float = 4.0
    branch_weights: Optional[List[float]] = None   # v2: [5,5,5,1,1,1]
    cast_weights: Optional[List[float]] = None     # v2: [1,1,1,1,5,5]
    distill: bool = True

    # ---- dataset jitters ----
    x_jitter: int = 10            # pixels (lidar/bev image jitter)
    a_jitter: int = 30
    nxp_jitter: int = 10
    angle_jitter: float = 30.0    # degrees
    stack_loc_jitter: float = 0.0  # meters, v2: 0.4
    stack_ori_jitter: float = 0.0  # radians, v2: 0.1

    # ---- feature (crop) augmentation ----
    feature_x_jitter: float = 1.5     # meters
    feature_angle_jitter: float = 20.0  # degrees
    use_others_to_train: bool = True

    # ---- cameras ----
    camera_x: float = 1.5
    camera_z: float = 2.4
    camera_yaws: List[float] = field(default_factory=lambda: [-120, -60, 0, 60, 120])
    crop_rgb: int = 20
    crop_tel_bottom: int = 96
    seg_channels: List[int] = field(default_factory=lambda: [4, 6, 7, 10])

    # ---- LiDAR / BEV geometry ----
    backbone: str = "cnn"
    min_x: float = -10.0
    max_x: float = 70.0
    min_y: float = -40.0
    max_y: float = 40.0
    pixels_per_meter: int = 4
    max_points_per_pillar: int = 100
    max_lidar_points: int = 40000
    num_frame_stack: int = 0      # v2: 2
    point_painting: bool = True
    num_features: List[int] = field(default_factory=lambda: [32, 32])

    # ---- object filtering ----
    max_vehicle_radius: float = 15.0
    max_mot_vehicle_radius: Optional[float] = None  # v2: 15 (with vehicle_radius 25)
    max_pedestrian_radius: float = 10.0
    max_objs: int = 20
    max_num_cars: int = 5         # teacher forward car cap (reference bev_planner.py:12)
    max_num_cars_student: int = 4  # student forward car cap (reference uniplanner.py:12)

    # ---- detection / inference ----
    max_det: int = 15
    det_max_pool_ks: int = 7
    det_min_score: float = 0.1

    # ---- agent overrides (v1 vs v2 differ, team_code/lav_agent.py:244,264
    # vs team_code_v2/lav_agent.py:337,382) ----
    brake_net_thresh: float = 0.3
    collide_dist_static: float = 2.0
    collide_dist_moving: float = 2.0

    # ---- controller ----
    aim_point: object = 4          # int (v1) or per-cmd list (v2 agent)
    speed_ratio: object = 1.0      # float or per-cmd list
    turn_KP: float = 1.0
    turn_KI: float = 0.5
    turn_KD: float = 0.2
    turn_n: int = 40
    speed_KP: float = 5.0
    speed_KI: float = 0.5
    speed_KD: float = 1.0
    speed_n: int = 40
    brake_speed: float = 0.2
    brake_ratio: float = 1.1
    clip_delta: float = 0.25
    max_throttle: float = 0.8
    max_speed: float = 35.0
    no_forecast: bool = False
    no_refine: bool = False

    # ---- data ----
    percentage_data: float = 1.01
    all_towns: bool = True
    data_dir: object = ""

    # ---- checkpoints ----
    lidar_model_dir: str = ""
    bev_model_dir: str = ""
    uniplanner_dir: str = ""
    bra_model_dir: str = ""
    seg_model_dir: str = ""

    # ------------------------------------------------------------------
    # derived geometry (reference point_pillar.py:47-48, lav_agent.py:94)
    # ------------------------------------------------------------------
    @property
    def nx(self) -> int:
        return int((self.max_x - self.min_x) * self.pixels_per_meter)

    @property
    def ny(self) -> int:
        return int((self.max_y - self.min_y) * self.pixels_per_meter)

    @property
    def y_offset(self) -> float:
        """Planner crop y-offset: ego sits at this normalized offset in the BEV.

        Matches `1 + min_x / ((max_x - min_x) / 2)` (reference lav_agent.py:94).
        """
        return 1.0 + self.min_x / ((self.max_x - self.min_x) / 2.0)

    @property
    def num_input(self) -> int:
        """Per-point feature count BEFORE pillar decoration.

        v1 train: 4 (xyzr) + len(seg_channels) painted = 8 -> decorated 13?  No:
        the reference counts the decorated size: raw per-point dims + 5
        decoration channels.  v1: painted lidar has 4+len(seg) dims; the
        reference passes num_input = len(seg)+9 (lav_final.py:32) which is
        (4 + len(seg)) + 5.  v2 agent adds num_frame_stack+1 age one-hots:
        len(seg)+10+num_frame_stack (lav_agent.py:81) = (4+len(seg)+stack+1)+5.
        """
        d = 4 + (len(self.seg_channels) if self.point_painting else 0)
        if self.num_frame_stack > 0:
            d += self.num_frame_stack + 1
        return d + 5

    @property
    def bev_input_channels(self) -> int:
        """BEV teacher input channels: 5 (v1) or 3+2*(stack+1) (v2)."""
        if self.num_frame_stack > 0:
            return 3 + 2 * (self.num_frame_stack + 1)
        return 5

    @property
    def uniplanner_input_channels(self) -> int:
        return self.num_features[-1] * 6

    def replace(self, **kw) -> "LAVConfig":
        return dataclasses.replace(self, **kw)


def load_config(path: str) -> LAVConfig:
    """Load a LAV-format YAML config into a typed LAVConfig; keys that are
    no field of it are ignored."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    names = {f.name for f in dataclasses.fields(LAVConfig)}
    kept = {k: v for k, v in raw.items() if k in names}
    return LAVConfig(**kept)


def v1_config(**overrides) -> LAVConfig:
    """The v1 training configuration (reference config.yaml)."""
    return LAVConfig().replace(**overrides)


def v2_config(**overrides) -> LAVConfig:
    """The v2 training configuration (reference config_v2.yaml)."""
    cfg = LAVConfig(
        num_plan=20,
        num_frame_stack=2,
        max_lidar_points=120000,
        max_vehicle_radius=25.0,
        max_mot_vehicle_radius=15.0,
        angle_jitter=20.0,
        stack_loc_jitter=0.4,
        stack_ori_jitter=0.1,
        branch_weights=[5, 5, 5, 1, 1, 1],
        cast_weights=[1, 1, 1, 1, 5, 5],
        num_features=[64, 64],
        aim_point=[4, 4, 4, 3, 6, 6],
        # deployed v2 controller gains (team_code_v2/config.yaml:65-79);
        # round-3 control-trace oracle caught the earlier wrong values
        speed_ratio=[0.8, 0.8, 0.8, 0.6, 0.8, 0.8],
        turn_KP=0.8,
        brake_net_thresh=0.1,
        collide_dist_static=1.0,
        collide_dist_moving=2.5,
    )
    return cfg.replace(**overrides)


def tiny_config(**overrides) -> LAVConfig:
    """A miniature config for fast unit tests: 8x smaller grid, short plans."""
    cfg = LAVConfig(
        num_plan=4,
        num_plan_iter=2,
        min_x=-4.0,
        max_x=12.0,
        min_y=-8.0,
        max_y=8.0,
        pixels_per_meter=2,
        crop_size=16,
        max_lidar_points=256,
        max_objs=4,
        max_num_cars=2,
        max_num_cars_student=2,
        max_det=5,
        num_features=[8, 8],
        turn_n=8,
        speed_n=8,
    )
    return cfg.replace(**overrides)
