"""CARLA leaderboard adapter: the live-simulator deployment surface
(counterpart of `lav_tpu/agent/carla_adapter.py`).

Wraps the agent (`agent/agent.py`) in the leaderboard's AutonomousAgent
protocol (sensors() / setup() / run_step() / destroy(), LAV
team_code_v2/lav_agent.py:37-198), so that it drops into
`leaderboard/scripts/run_evaluation.sh` unchanged.  carla and leaderboard
are imported lazily: present on an evaluation host, absent elsewhere.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lav_tpu_torch.agent.agent import AgentModels, build_agent
from lav_tpu_torch.agent.env import obs_to_tensors
from lav_tpu_torch.agent.route import (
    RoutePlanner, Waypointer, cmd_to_model_value,
)
from lav_tpu_torch.config import LAVConfig, load_config, v2_config
from lav_tpu_torch.utils.device import resolve_device

CAMERA_YAWS = (-60, 0, 60)


def get_entry_point():
    return "LAVAgent"


def sensor_suite(camera_x: float, camera_z: float):
    """The reference sensor layout (team_code_v2/lav_agent.py:38-60)."""
    sensors = [
        {"type": "sensor.speedometer", "id": "EGO"},
        {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": camera_z,
         "id": "GPS"},
        {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": camera_z,
         "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.05,
         "id": "IMU"},
        {"type": "sensor.lidar.ray_cast", "x": 0.0, "y": 0.0, "z": camera_z,
         "yaw": 0.0, "pitch": 0.0, "roll": 0.0, "id": "LIDAR"},
    ]
    for i, yaw in enumerate(CAMERA_YAWS):
        sensors.append({
            "type": "sensor.camera.rgb", "x": camera_x, "y": 0.0,
            "z": camera_z, "roll": 0.0, "pitch": 0.0, "yaw": yaw,
            "width": 256, "height": 288, "fov": 64, "id": f"RGB_{i}",
        })
    sensors.append({
        "type": "sensor.camera.rgb", "x": camera_x, "y": 0.0, "z": camera_z,
        "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "width": 480, "height": 288,
        "fov": 40, "id": "TEL_RGB",
    })
    return sensors


class LAVAgentCore:
    """Simulator-agnostic agent core: host route following plus the
    agent's one-ego step on `device` (default `cuda`; raises without a
    card unless `device='cpu'`), where `models` are moved.

    A raw sweep is padded or cut to `max_points` (its first points kept),
    as lav_tpu does: a CARLA sweep of tens of thousands of points loses
    the rest."""

    def __init__(self, cfg: LAVConfig, models, max_points: int = 8192,
                 rgb_hw=(288, 256), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = models.to(self.device).eval()
        init_state, self.step = build_agent(
            cfg, max_points=max_points, rgb_hw=rgb_hw, device=self.device)
        self.state = init_state()
        self.max_points = max_points
        self.waypointer: Optional[Waypointer] = None
        self.planner: Optional[RoutePlanner] = None
        self._global_plan = None

    def set_global_plan(self, global_plan):
        self._global_plan = global_plan

    def run_step(self, lidar, rgbs, tel_rgb, gps, compass, speed):
        """-> (steer, throttle, brake) floats and the step's aux dict."""
        if self.waypointer is None:
            self.waypointer = Waypointer(self._global_plan, gps)
            self.planner = RoutePlanner(self._global_plan)
        _, _, cmd = self.waypointer.tick(gps)
        target = self.planner.run_step(gps)

        pts = np.zeros((self.max_points, 4), np.float32)
        valid = np.zeros((self.max_points,), bool)
        n = min(len(lidar), self.max_points)
        pts[:n] = lidar[:n, :4]
        valid[:n] = True

        obs = obs_to_tensors([dict(
            lidar=pts,
            lidar_valid=valid,
            rgbs=np.asarray(rgbs, np.float32),
            tel_rgb=np.asarray(tel_rgb, np.float32),
            gps=np.asarray(gps[:2], np.float32),
            compass=np.float32(compass),
            speed=np.float32(speed),
            cmd=np.int32(cmd_to_model_value(cmd)),
            target=target.astype(np.float32),
        )], self.device)
        ctrl, self.state, aux = self.step(self.models, self.state, obs)
        return (float(ctrl.steer[0]), float(ctrl.throttle[0]),
                float(ctrl.brake[0]), aux)


try:  # pragma: no cover - only on a CARLA evaluation host
    import carla  # type: ignore
    from leaderboard.autoagents.autonomous_agent import (  # type: ignore
        AutonomousAgent, Track,
    )

    class LAVAgent(AutonomousAgent):
        def sensors(self):
            return sensor_suite(self._cfg.camera_x, self._cfg.camera_z)

        def setup(self, path_to_conf_file):
            """Seeded random weights (the brake net in version 2), then
            each stage's checkpoint where the config points at one: a
            snapshot or a bare state_dict, as the training CLI saves."""
            from lav_tpu_torch.train.checkpoints import load_params

            self.track = Track.SENSORS
            self._cfg = (load_config(path_to_conf_file)
                         if path_to_conf_file else v2_config())
            cfg = self._cfg
            models = AgentModels(cfg, brake_version=2,
                                 gen=torch.Generator().manual_seed(0))
            for name, path in (
                ("lidar_model", cfg.lidar_model_dir),
                ("uniplanner", cfg.uniplanner_dir),
                ("seg_model", cfg.seg_model_dir),
                ("bra_model", cfg.bra_model_dir),
            ):
                if path:
                    load_params(path, getattr(models, name))
            # lav_tpu's step picks the brake head by the config (version 1
            # without a temporal stack), whatever weights it holds
            if cfg.num_frame_stack == 0:
                models.bra_model.version = 1
            self.core = LAVAgentCore(cfg, models)

        def run_step(self, input_data, timestamp):
            _, lidar = input_data.get("LIDAR")
            _, gps = input_data.get("GPS")
            _, imu = input_data.get("IMU")
            _, ego = input_data.get("EGO")
            rgbs = [input_data.get(f"RGB_{i}")[1][..., :3][..., ::-1]
                    for i in range(len(CAMERA_YAWS))]
            tel = input_data.get("TEL_RGB")[1][..., :3][..., ::-1]
            tel = tel[:-self._cfg.crop_tel_bottom]
            if self.core._global_plan is None:
                self.core.set_global_plan(self._global_plan)
            steer, throttle, brake, _ = self.core.run_step(
                lidar, np.stack(rgbs), tel, gps, imu[-1], ego.get("speed"))
            return carla.VehicleControl(
                steer=steer, throttle=throttle, brake=brake)

        def destroy(self):
            self.core = None

except ImportError:  # no carla: replay-only deployment
    LAVAgent = None  # type: ignore
