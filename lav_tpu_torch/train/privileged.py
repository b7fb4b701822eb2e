"""Stage-1 trainers: the privileged BEV planner, camera segmentation and
the brake net (counterpart of `lav_tpu/train/privileged.py`).

Each step is lav_tpu's value_and_grad + optax.adam + merge_bn_state as
PyTorch does it, in f32 and in train mode: backward, `torch.optim.Adam`
(`distill.adam`), then the BN running statistics of the forward are
written (`utils/tree.py::merge_bn_state`).  Each returns its loss terms
and `grad_norm` (optax's global norm over every gradient) as 0-dim
tensors on the models' device; nothing waits for the device.  The
backward and the optimizer's tail carry the `torch.profiler` labels
`privileged/backward` and `privileged/optimizer` (`distill.optimizer_step`).

  BEV    `bev_planner_forward` on the ground-truth BEV, which is data: its
         crops run kernel `crop_shared` and no backward kernel.  v1 and
         v2 losses (`make_bev_loss_fn`).  Noise from a CPU generator, as
         the distillation step draws it.
  seg    ERFNet with dropout, its masks drawn from a generator on the
         models' device or handed in; cross entropy.
  brake  the brake net with its auxiliary seg head: BCE of the brake
         probability plus half the cross entropy of each stream's seg.

`bev_setup`, `seg_setup` and `bra_setup` build a step with weights from
a seed, Adam(3e-4) and a batch drawn from numpy's default_rng(seed) as
`lav_tpu/utils/bench_train.py` draws it, on the card unless asked for
the CPU.  `step_lr` is lav_tpu's staircase decay (torch's StepLR).
Left out, as in `train/distill.py`: a compute dtype other than f32.
"""

from __future__ import annotations

import numpy as np
import torch

from lav_tpu_torch import parallel
from lav_tpu_torch.config import LAVConfig, v1_config, v2_config
from lav_tpu_torch.models import losses
from lav_tpu_torch.models.planner import (
    BEVPlanner, bev_planner_forward, draw_bev_noise,
)
from lav_tpu_torch.models.rgb import BRAKE_SEG_CHANNELS, BrakeModel, SegModel
from lav_tpu_torch.parallel import batch_mean
from lav_tpu_torch.train.distill import adam, optimizer_step
from lav_tpu_torch.utils.device import resolve_device

SEG_HW = (288, 256)                 # bench_train.py's camera image
BRA_HW = ((288, 768), (192, 480))   # its wide concat and telephoto


def make_bev_loss_fn(cfg: LAVConfig, v2: bool = False):
    """loss_terms(out, batch, other_weight=1.0) -> (loss, metrics) of the
    `bev_planner_forward` outputs (lav_tpu `make_bev_loss_fn`).  v2 masks
    the plan loss to the frames without brake (`bras == 0`), weights each
    item by its command's branch weight, smooths the command targets and
    weights the other cars' loss by `other_weight` (0 unless
    cfg.use_others_to_train)."""

    def loss_terms(out, batch, other_weight=1.0):
        ego_gt = batch["ego_locs"][:, 1:]
        cmds = batch["cmds"].long()
        if v2:
            bw = (None if not cfg.branch_weights else torch.tensor(
                cfg.branch_weights, dtype=torch.float32,
                device=cmds.device)[cmds])
            plan_l = losses.plan_loss_all_cmds(
                out.ego_plan_locs, ego_gt, idxs=batch["bras"] == 0,
                item_weights=bw)
            cmd_l = losses.cmd_bce(out.ego_cast_cmds, cmds, cfg.num_cmds,
                                   smooth=cfg.cmd_smooth)
            ow = other_weight if cfg.use_others_to_train else 0.0
        else:
            plan_l = losses.plan_loss_all_cmds(out.ego_plan_locs, ego_gt)
            cmd_l = losses.cmd_bce(out.ego_cast_cmds, cmds, cfg.num_cmds)
            ow = 1.0
        cast_l = losses.cast_loss_at_cmd(out.ego_cast_locs, ego_gt, cmds)
        other_l = losses.other_cast_loss_min_mode(
            out.other_cast_locs, out.other_locs, out.car_valid)
        loss = plan_l + cast_l + other_l * ow + cmd_l * cfg.cmd_weight
        metrics = dict(loss=loss, plan_loss=plan_l, ego_cast_loss=cast_l,
                       other_cast_loss=other_l, cmd_loss=cmd_l)
        return loss, metrics

    return loss_terms


def make_bev_train_step(cfg: LAVConfig, v2: bool = False):
    """step(models, optimizer, batch, gen=None, noise=None,
    other_weight=1.0) -> metrics, models a `BEVPlanner`.  batch: bev (B,
    H, W, C) NHWC, ego_locs (B, T+1, 2), cmds (B,), nxps (B, 2), bras
    (B,), locs (B, N, T+1, 2), oris (B, N), typs (B, N).  The forward's
    noise is drawn from the CPU torch.Generator `gen` unless `noise` is
    given (`draw_bev_noise`)."""
    loss_terms = make_bev_loss_fn(cfg, v2=v2)

    def step(models, optimizer, batch, gen=None, noise=None,
             other_weight=1.0):
        models.train()
        if noise is None:   # the global batch's draws, this rank's rows
            B, N = batch["typs"].shape
            noise = parallel.local_rows(draw_bev_noise(
                gen, parallel.global_rows(B), N - 1, cfg.max_num_cars,
                device=batch["typs"].device))
        optimizer.zero_grad(set_to_none=True)
        out = bev_planner_forward(models, cfg, batch["bev"],
                                  batch["ego_locs"], batch["locs"],
                                  batch["oris"], batch["nxps"],
                                  batch["typs"], noise)
        loss, metrics = loss_terms(out, batch, other_weight)
        return optimizer_step(models, optimizer, loss, metrics,
                              span="privileged")

    return step


def make_seg_train_step(cfg: LAVConfig):
    """step(models, optimizer, batch, gen=None, masks=None) -> metrics,
    models a `SegModel`.  batch: rgb (B, H, W, 3) 0-255 floats, sem (B, H,
    W) int labels.  ERFNet's dropout masks are `masks` or drawn from the
    torch.Generator `gen` on the models' device."""

    def step(models, optimizer, batch, gen=None, masks=None):
        models.train()
        optimizer.zero_grad(set_to_none=True)
        logits = models(batch["rgb"], masks=masks, gen=gen)
        loss = batch_mean(losses.cross_entropy(logits, batch["sem"]))
        return optimizer_step(models, optimizer, loss, dict(loss=loss),
                              span="privileged")

    return step


def make_bra_train_step(cfg: LAVConfig, version: int = 1):
    """step(models, optimizer, batch) -> metrics, models a `BrakeModel` of
    `version`.  batch: rgb (wide concat, B, H, W, 3), tel_rgb (B, H2, W2,
    3), sem (B, H, W) and tel_sem (B, H2, W2) int labels, bra (B,) 0/1:
    bce(pred, bra) + 1/2 CE(sem1, sem) + 1/2 CE(sem2, tel_sem)."""

    def step(models, optimizer, batch):
        if models.version != version:
            raise ValueError(f"a version {version} step for a version "
                             f"{models.version} brake net")
        models.train()
        optimizer.zero_grad(set_to_none=True)
        pred, sem1, sem2 = models(batch["rgb"], batch["tel_rgb"],
                                  with_mask=True)
        loss = (batch_mean(losses.bce(pred, batch["bra"].to(pred.dtype)))
                + 0.5 * batch_mean(losses.cross_entropy(sem1, batch["sem"]))
                + 0.5 * batch_mean(losses.cross_entropy(sem2,
                                                        batch["tel_sem"])))
        return optimizer_step(models, optimizer, loss, dict(loss=loss),
                              span="privileged")

    return step


def step_lr(optimizer, base_lr: float, steps_per_epoch: int,
            step_size_epochs: int, gamma: float = 0.5):
    """lav_tpu's `step_lr` (optax.exponential_decay with staircase=True,
    torch's StepLR of LAV): sets the optimizer's learning rate to base_lr
    and returns a scheduler whose `.step()`, called after each optimizer
    step, makes update n (from 0) use base_lr * gamma ** (n //
    (steps_per_epoch * step_size_epochs))."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr
        group.pop("initial_lr", None)
    every = steps_per_epoch * step_size_epochs
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda n: gamma ** (n // every))


def _to(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def bev_batch(cfg: LAVConfig, batch_size: int, seed: int = 0,
              device=None) -> dict:
    """A random BEV batch drawn as lav_tpu's `bench_train.py::bench_bev`
    draws it, from numpy's default_rng(seed), on `device` (default the
    card)."""
    rng = np.random.default_rng(seed)
    bs, T, N = batch_size, cfg.num_plan, cfg.max_objs
    f32 = np.float32
    return _to(dict(
        bev=rng.uniform(0, 1, (bs, cfg.ny, cfg.nx, cfg.bev_input_channels)
                        ).astype(f32),
        ego_locs=np.cumsum(rng.normal(size=(bs, T + 1, 2)), 1).astype(f32),
        cmds=np.zeros((bs,), np.int32),
        nxps=rng.normal(size=(bs, 2)).astype(f32),
        bras=np.zeros((bs,), np.int32),
        locs=rng.normal(size=(bs, N, T + 1, 2)).astype(f32),
        oris=np.zeros((bs, N), f32),
        typs=np.ones((bs, N), np.int32),
    ), resolve_device(device))


def seg_batch(batch_size: int, n_sem: int, seed: int = 0, device=None,
              hw=SEG_HW) -> dict:
    """A random seg batch as `bench_seg` draws it (images of `hw`)."""
    rng = np.random.default_rng(seed)
    return _to(dict(
        rgb=rng.uniform(0, 255, (batch_size, *hw, 3)).astype(np.float32),
        sem=rng.integers(0, n_sem + 1, (batch_size, *hw)).astype(np.int32),
    ), resolve_device(device))


def bra_batch(batch_size: int, seed: int = 0, device=None,
              hws=BRA_HW) -> dict:
    """A random brake batch as `bench_bra` draws it (wide and telephoto
    images of `hws`, labels of the brake net's seg head)."""
    rng = np.random.default_rng(seed)
    (h, w), (h2, w2) = hws
    bs, f32, n_sem = batch_size, np.float32, BRAKE_SEG_CHANNELS
    return _to(dict(
        rgb=rng.uniform(0, 255, (bs, h, w, 3)).astype(f32),
        tel_rgb=rng.uniform(0, 255, (bs, h2, w2, 3)).astype(f32),
        sem=rng.integers(0, n_sem + 1, (bs, h, w)).astype(np.int32),
        tel_sem=rng.integers(0, n_sem + 1, (bs, h2, w2)).astype(np.int32),
        bra=rng.integers(0, 2, (bs,)).astype(np.int32),
    ), resolve_device(device))


def bev_setup(batch_size: int = 64, device=None, seed: int = 0,
              cfg: LAVConfig = None, v2: bool = True, lr: float = 3e-4):
    """The BEV step (`bench_bev`: v2_config(), or v1_config() when not
    v2, unless `cfg`) with weights from `seed`, Adam(lr) and a `bev_batch`
    on `device` (default the card; raises without one unless 'cpu').
    Returns (step, models, optimizer, batch, gen, cfg), gen the CPU
    generator the step draws its noise from (seeded with seed + 1)."""
    dev = resolve_device(device)
    cfg = cfg or (v2_config() if v2 else v1_config())
    models = BEVPlanner(cfg, torch.Generator().manual_seed(seed)).to(dev)
    return (make_bev_train_step(cfg, v2=v2), models, adam(models, lr),
            bev_batch(cfg, batch_size, seed, dev),
            torch.Generator().manual_seed(seed + 1), cfg)


def _device_gen(dev, seed: int):
    return torch.Generator(device=dev).manual_seed(seed)


def seg_setup(batch_size: int = 32, device=None, seed: int = 0,
              cfg: LAVConfig = None, lr: float = 3e-4):
    """The seg step (`bench_seg`: v1_config()'s seg channels) as
    `bev_setup`; gen is a generator on `device` (seeded with seed + 1)
    for the dropout masks."""
    dev = resolve_device(device)
    cfg = cfg or v1_config()
    n_sem = len(cfg.seg_channels)
    models = SegModel(n_sem, torch.Generator().manual_seed(seed)).to(dev)
    return (make_seg_train_step(cfg), models, adam(models, lr),
            seg_batch(batch_size, n_sem, seed, dev),
            _device_gen(dev, seed + 1), cfg)


def bra_setup(batch_size: int = 8, device=None, seed: int = 0,
              cfg: LAVConfig = None, version: int = 2, lr: float = 3e-4):
    """The brake step of `version` (`bench_bra`) as `bev_setup`, with no
    generator: it draws nothing.  Returns (step, models, optimizer, batch,
    cfg)."""
    dev = resolve_device(device)
    cfg = cfg or v1_config()
    models = BrakeModel(version, torch.Generator().manual_seed(seed)).to(dev)
    return (make_bra_train_step(cfg, version), models, adam(models, lr),
            bra_batch(batch_size, seed, dev), cfg)
