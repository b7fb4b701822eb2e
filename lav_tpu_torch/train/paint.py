"""The offline point-painting pass (counterpart of `lav_tpu/train/paint.py`).

For each frame, the seg model segments every camera and the sweep's points
take the class probabilities of the pixel they project to
(`ops/painting.py::point_painting`); the painted semantics are committed
back to the episode store as `lidar_sem_{t}`, which the painted lidar
datasets read.  As in lav_tpu, only a writable store takes the commit:
the in-memory `DictStore`.  A `.lavpack` store has no `put` and an LMDB
store opens read-only, so paint `DictStore` episodes, then pack them
(`data/lavpack.py::convert_episode`).

    python -m lav_tpu_torch.train.paint --config-path config.yaml \
        --seg-checkpoint checkpoints/seg/seg_1
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lav_tpu_torch.config import load_config, v1_config
from lav_tpu_torch.data.datasets import get_dataset
from lav_tpu_torch.models.rgb import SegModel
from lav_tpu_torch.ops.painting import CameraRig, point_painting
from lav_tpu_torch.train.checkpoints import load_params
from lav_tpu_torch.utils.device import resolve_device


def make_paint_fn(cfg, rgb_hw=(288, 256), fov=64):
    """paint(seg_model, rgbs (num_cams, H, W, 3), lidar_xyz (P, 3),
    lidar_valid (P,)) -> (P, n_sem), on the model's device, in eval mode
    and without a gradient."""
    rigs = tuple(
        CameraRig.build(yaw, lidar_xyz=(0, 0, cfg.camera_z),
                        cam_xyz=(cfg.camera_x, 0, cfg.camera_z),
                        rgb_h=rgb_hw[0], rgb_w=rgb_hw[1], fov=fov)
        for yaw in cfg.camera_yaws)

    @torch.no_grad()
    def paint(seg_model, rgbs, lidar_xyz, lidar_valid):
        prob = torch.softmax(seg_model.eval()(rgbs), dim=-1)
        # class probabilities times the foreground's (LAV's data_paint.py:
        # sems[:, 1:] * (1 - sems[:, :1]))
        sem = prob[..., 1:] * (1.0 - prob[..., :1])
        return point_painting(lidar_xyz[None], sem[None], rigs,
                              valid=lidar_valid[None])[0]

    return paint


def run_paint(cfg, seg_model, episodes=None, max_points: int = 40000,
              rgb_hw=(288, 256)):
    """Paint every frame of `episodes` (default cfg.data_dir's) with
    `seg_model` and commit; returns the number of frames."""
    ds = get_dataset("point_paint", cfg, episodes)
    paint = make_paint_fn(cfg, rgb_hw=rgb_hw)
    dev = next(seg_model.parameters()).device
    for i in range(len(ds)):
        s = ds[i]
        n = len(s["lidar"])
        pts = np.zeros((max_points, 3), np.float32)
        valid = np.zeros((max_points,), bool)
        k = min(n, max_points)
        pts[:k] = s["lidar"][:k, :3]
        valid[:k] = True
        painted = paint(
            seg_model, torch.from_numpy(s["rgbs"].astype(np.float32)).to(dev),
            torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev),
        ).cpu().numpy()
        out = np.zeros((n, painted.shape[-1]), np.float32)
        out[:k] = painted[:k]
        ds.commit(i, out)
    return len(ds)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-path", default=None)
    p.add_argument("--seg-checkpoint", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config_path) if args.config_path else v1_config()
    model = load_params(args.seg_checkpoint, SegModel(len(cfg.seg_channels)))
    n = run_paint(cfg, model.to(dev))
    print(f"painted {n} frames")
    return n


if __name__ == "__main__":
    main()
