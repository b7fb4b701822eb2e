"""Stage-2 trainer: LiDAR perception plus distillation from the frozen BEV
teacher (counterpart of `lav_tpu/train/distill.py`).

The losses (`make_distill_loss_fn`): CenterNet-style detection, BEV
segmentation BCE (v2: weighted by a Gaussian around the ego), and motion
losses distilled from the teacher inside `uniplanner_forward`.  Modes, as
LAV's --perceive-only / --motion-only flags:
  'full'          mot + det + seg (v1) or mot + (det + seg) *
                  perception_weight (v2)
  'perceive_only' det + seg
  'motion_only'   mot only

The step (`make_full_train_step`) is lav_tpu's value_and_grad + optax.adam
+ merge_bn_state as PyTorch does it: backward, `torch.optim.Adam` (the
same update, m_hat / (sqrt(v_hat) + eps), no weight decay; `adam`), then
the BN running statistics of the forward are written
(`utils/tree.py::merge_bn_state`).  The teacher's parameters take no
gradient, and the never-evaluated `other` cast bank gets none either, so
Adam leaves both as they are, as optax does with their zero gradients.
`grad_norm` is optax's global norm, over every gradient.  The step runs
where the models and the batch are: `distill_setup` puts them on the card
unless asked for the CPU.

`compute_dtype` (lav_tpu's `--dtype`): the lidar points and the BEV are
cast to it, so the lidar model, the canvas max and its backward, the
student's crops and their backward, the crop ResNets and the teacher's
BEV crops run in it; the head maps go back to f32 for the losses.  The
params, Adam's moments and the BN running statistics stay f32 (each layer
casts its f32 weights to its input's dtype; BN takes its statistics in
f32).  `remat` (lav_tpu's `--remat`) runs the lidar forward and the
planner forward each under `utils/tree.py::checkpoint`, which recomputes
their activations in the backward pass and keeps the forward's BN
updates.  lav_tpu's policy `dots_with_no_batch_dims_saveable` keeps some
matmul outputs instead of recomputing them: an XLA memory tactic that
changes no number, so saving nothing computes the same function.  In f32
at B >= 32 `uniplanner_forward` also scopes lav_tpu's checkpoint over the
student crops, with or without `remat`.

The step carries `torch.profiler` labels, which record nothing without a
profiler: `distill/forward/lidar`, `distill/forward/planner` (the student
with its teacher) and `distill/forward/loss`; `distill/backward` over the
whole backward pass on the thread that runs it, autograd's device thread
for a loss on a card (`utils/profiling.py::backward_span`), with remat's
recomputes under it as `distill/backward/recompute/lidar`, `/planner` and
`/crops` (`utils/tree.py::checkpoint`); `distill/optimizer` over the
tail (a data mesh's gradient sum, `grad_norm`, the optimizer's step, the
BN merge).  The stage-1 trainers (`train/privileged.py`) label the same
tail `privileged/backward` and `privileged/optimizer`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from lav_tpu_torch import parallel
from lav_tpu_torch.config import LAVConfig, v2_config
from lav_tpu_torch.core.heatmap import build_seg_mask
from lav_tpu_torch.models import losses
from lav_tpu_torch.models.lidar import LidarModel
from lav_tpu_torch.models.planner import (
    UniPlanner, draw_noise, uniplanner_forward,
)
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import backward_span
from lav_tpu_torch.utils.tree import checkpoint, merge_bn_state

MODES = ("full", "perceive_only", "motion_only")


def make_distill_loss_fn(cfg: LAVConfig, v2: bool = False,
                         mode: str = "full"):
    """loss_terms(preds, out, batch) -> (loss, metrics), with preds =
    (hm, size, ori, pred_bev) the lidar model's f32 maps and out the
    `uniplanner_forward` outputs (lav_tpu `make_distill_loss_fn`)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    # v1 trains BEV channels [0, 3, 4], v2 [0, 1, 2]
    seg_ch = (0, 1, 2) if v2 else (0, 3, 4)

    def loss_terms(preds, out, batch):
        hm, size, ori, pred_bev = preds
        dev = hm.device
        cmds = batch["cmds"].long()
        hm_l, box_l, ori_l = losses.det_loss(
            hm, batch["heatmaps"], size, batch["sizemaps"], ori,
            batch["orimaps"])
        det_l = hm_l + cfg.box_weight * box_l + cfg.ori_weight * ori_l

        seg_tgt = torch.stack([batch["bev"][..., c] for c in seg_ch], dim=1)
        seg_bce = losses.bce(pred_bev, seg_tgt)
        if v2:
            W, H = cfg.ny, cfg.nx
            cx = W / 2.0 + (cfg.min_y + cfg.max_y) / 2.0 * cfg.pixels_per_meter
            cy = H / 2.0 + (cfg.min_x + cfg.max_x) / 2.0 * cfg.pixels_per_meter
            seg_mask = build_seg_mask(H, W, cx, cy, device=dev)[None, None]
            seg_l = parallel.batch_mean(seg_bce * seg_mask) * cfg.seg_weight
        else:
            seg_l = parallel.batch_mean(seg_bce) * cfg.seg_weight

        if v2:
            # distil the plan from the teacher's last-iteration plan at the
            # GT command, each item weighted by its command's branch weight
            expert_plan = losses.gather_cmd(out.ego_plan_locs_expert[:, -1],
                                            cmds)
            bw = (None if not cfg.branch_weights else torch.tensor(
                cfg.branch_weights, dtype=torch.float32, device=dev)[cmds])
            plan_l = losses.plan_loss_all_cmds(
                out.ego_plan_locs, expert_plan.detach(), item_weights=bw)
        else:
            # LAV's quirk: the raw ego future, though the plan is in the
            # jittered frame
            plan_l = losses.plan_loss_all_cmds(out.ego_plan_locs,
                                               batch["ego_locs"][:, 1:])
        if cfg.distill:
            cast_l = losses.distill_l1(out.ego_cast_locs,
                                       out.ego_cast_locs_expert)
            other_l = losses.distill_l1(out.other_cast_locs,
                                        out.other_cast_locs_expert,
                                        out.car_valid)
            cmd_l = losses.cmd_distill_bce(out.other_cast_cmds,
                                           out.other_cast_cmds_expert,
                                           out.car_valid)
        else:
            sel = losses.gather_cmd(out.ego_cast_locs, cmds)
            cast_l = losses.masked_mean(
                torch.abs(sel - batch["ego_locs"][:, 1:]).mean(dim=(1, 2)),
                batch["bras"] == 0)
            other_l = losses.other_cast_loss_min_mode(
                out.other_cast_locs, out.other_locs, out.car_valid)
            cmd_l = losses.cmd_bce(out.ego_cast_cmds, cmds, cfg.num_cmds,
                                   smooth=cfg.cmd_smooth)
        ow = cfg.other_weight if cfg.use_others_to_train else 0.0
        mot_l = plan_l + cast_l + other_l * ow + cmd_l * cfg.cmd_weight

        if mode == "perceive_only":
            loss = det_l + seg_l
        elif mode == "motion_only":
            loss = mot_l
        elif v2:
            loss = mot_l + (det_l + seg_l) * cfg.perception_weight
        else:
            loss = mot_l + det_l + seg_l
        metrics = dict(loss=loss, hm_loss=hm_l, box_loss=box_l,
                       ori_loss=ori_l, seg_loss=seg_l, plan_loss=plan_l,
                       ego_cast_loss=cast_l, other_cast_loss=other_l,
                       cmd_loss=cmd_l)
        return loss, metrics

    return loss_terms


def make_distill_forward(cfg: LAVConfig, v2: bool = False,
                         mode: str = "full", compute_dtype=None,
                         remat: bool = False):
    """forward(models, batch, noise) -> (loss, metrics): the lidar model,
    the student with its teacher, and the losses, in the models' current
    mode (lav_tpu `make_distill_forward` with train=True is the models in
    train mode), the points and the BEV in `compute_dtype` (default f32),
    the two forwards recomputed in the backward pass with `remat` (see the
    module note).  `models` as `distill_models` builds it; noise from
    `planner.draw_noise`."""
    loss_terms = make_distill_loss_fn(cfg, v2=v2, mode=mode)
    cdt = compute_dtype or torch.float32

    def forward(models, batch, noise):
        lidar = models["lidar_model"]
        planner = functools.partial(uniplanner_forward, models["uniplanner"],
                                    cfg)

        def run(fn, *args, module, span):
            return (checkpoint(fn, *args, module=module,
                               span=f"distill/backward/recompute/{span}")
                    if remat else fn(*args))

        with record_function("distill/forward/lidar"):
            feats, hm, size, ori, pred_bev = run(
                lidar, batch["lidar"].to(cdt), batch["lidar_valid"],
                module=lidar, span="lidar")[:5]
        with record_function("distill/forward/planner"):
            out = run(planner, feats, batch["bev"].to(cdt),
                      batch["ego_locs"], batch["locs"], batch["oris"],
                      batch["nxps"], batch["typs"], noise,
                      module=models["uniplanner"], span="planner")
        with record_function("distill/forward/loss"):
            # the losses in f32
            preds = (hm.float(), size.float(), ori.float(),
                     pred_bev.float())
            return loss_terms(preds, out, batch)

    return forward


def optimizer_step(models, optimizer, loss, metrics, span: str) -> dict:
    """The tail of every train step: backward, `grad_norm` (optax's global
    norm over every gradient) into `metrics`, the optimizer step and the
    BN merge; returns the metrics detached.  Under a data mesh
    (`parallel.reducing`) every rank seeds loss / N and the gradients are
    summed over the ranks before the norm: the global batch's gradient,
    once a micro-step, as lav_tpu's psum gives it.  `span` names the
    trainer in the profiler's labels: `<span>/backward`, then
    `<span>/optimizer` (see the module note)."""
    mesh = parallel.active()
    if mesh is not None:
        loss = loss / mesh.world
    backward_span(loss, f"{span}/backward").backward()
    with record_function(f"{span}/optimizer"):
        if mesh is not None:
            parallel.allreduce_grads(models, mesh)
        grads = [p.grad for p in models.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.sqrt(
            torch.stack([(g * g).sum() for g in grads]).sum())
        optimizer.step()
        merge_bn_state(models)
    return {k: v.detach() for k, v in metrics.items()}


def make_full_train_step(cfg: LAVConfig, v2: bool = False,
                         mode: str = "full", compute_dtype=None,
                         remat: bool = False):
    """step(models, optimizer, batch, gen=None, noise=None) -> metrics:
    one optimizer step in train mode, computing in `compute_dtype` (default
    f32), with `remat` recomputing the forwards in the backward pass
    (`make_distill_forward`).  The forward's noise is drawn from the CPU
    `torch.Generator` `gen` unless `noise` is given.  metrics holds the
    loss terms and `grad_norm`, as 0-dim tensors on the models' device
    (nothing waits for the device)."""
    forward = make_distill_forward(cfg, v2=v2, mode=mode,
                                   compute_dtype=compute_dtype, remat=remat)

    def step(models, optimizer, batch, gen=None, noise=None):
        models.train()
        if noise is None:   # the global batch's draws, this rank's rows
            B, N = batch["typs"].shape
            noise = parallel.local_rows(draw_noise(
                gen, parallel.global_rows(B), N - 1,
                cfg.max_num_cars_student, device=batch["typs"].device))
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = forward(models, batch, noise)
        return optimizer_step(models, optimizer, loss, metrics,
                              span="distill")

    return step


def distill_models(cfg: LAVConfig, gen=None) -> nn.ModuleDict:
    """{'lidar_model', 'uniplanner' (with its teacher)}, lav_tpu's params
    tree of the step, from the port's initialisers on `gen`."""
    geo = dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
               max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter)
    return nn.ModuleDict(dict(
        lidar_model=LidarModel(cfg.num_input, cfg.num_features, **geo,
                               gen=gen),
        uniplanner=UniPlanner(cfg, gen=gen, teacher=True)))


def adam(models: nn.Module, lr: float = 3e-4) -> torch.optim.Adam:
    """optax.adam(lr) over the trainable parameters: betas (0.9, 0.999),
    eps 1e-8 outside the square root, no weight decay."""
    return torch.optim.Adam([p for p in models.parameters()
                             if p.requires_grad], lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class MultiSteps:
    """optax.MultiSteps(opt, every_k_schedule=every_k) over the torch
    optimizer `optimizer` and the learning-rate `scheduler` (or None) that
    counts its updates; the train steps take it in the optimizer's place.

    Each `step()` is a micro-step.  It folds the gradients into their
    running mean as optax does (acc + (g - acc) / (n + 1)); every
    `every_k`-th, the optimizer steps on that mean, the scheduler steps
    once, and the mean starts again from zero.  In between the parameters
    stay as they are (optax applies zero updates), while a train step still
    merges the micro-batch's BN statistics and reports its own grad_norm.
    every_k = 1 is the optimizer and its scheduler alone.  `state_dict`
    holds all three states, the partial mean among them."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int = 1,
                 scheduler=None):
        if every_k < 1:
            raise ValueError(f"every_k {every_k}: at least 1")
        self.optimizer, self.every_k, self.scheduler = (optimizer, every_k,
                                                        scheduler)
        self.mini_step = 0
        self.acc: dict = {}     # parameter index -> running mean

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step; True where it applied an update."""
        if self.every_k > 1:
            n = self.mini_step
            params = self._params()
            for i, p in enumerate(params):
                if p.grad is None:
                    continue
                if i not in self.acc:
                    self.acc[i] = torch.zeros_like(p.grad)
                self.acc[i].add_((p.grad - self.acc[i]) / (n + 1))
            self.mini_step = n + 1
            if self.mini_step < self.every_k:
                return False
            for i, acc in self.acc.items():
                params[i].grad = acc
            self.acc, self.mini_step = {}, 0
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return True

    def state_dict(self) -> dict:
        return dict(optimizer=self.optimizer.state_dict(),
                    scheduler=(None if self.scheduler is None
                               else self.scheduler.state_dict()),
                    every_k=self.every_k, mini_step=self.mini_step,
                    acc=dict(self.acc))

    def load_state_dict(self, state: dict) -> None:
        if state["every_k"] != self.every_k:
            raise ValueError(f"a state of every_k {state['every_k']} for "
                             f"every_k {self.every_k}")
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        params = self._params()
        self.mini_step = state["mini_step"]
        self.acc = {i: a.to(params[i].device) for i, a in
                    state["acc"].items()}


def make_batch(cfg: LAVConfig, batch_size: int, max_points: int,
               seed: int = 0, device=None) -> dict:
    """A random batch drawn as lav_tpu's `utils/bench_train.py::bench_full`
    draws it, from numpy's default_rng(seed), on `device` (default the
    card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bs, T, N, C = batch_size, cfg.num_plan, cfg.max_objs, \
        cfg.bev_input_channels
    H, W = cfg.ny, cfg.nx
    f32 = np.float32
    arrays = dict(
        lidar=rng.uniform(-10, 40, (bs, max_points, cfg.num_input - 5)),
        heatmaps=rng.uniform(0, 1, (bs, 2, H, W)),
        sizemaps=rng.uniform(0, 8, (bs, 2, H, W)),
        orimaps=rng.uniform(-1, 1, (bs, 2, H, W)),
        bev=(rng.uniform(size=(bs, H, W, C)) > 0.5),
        ego_locs=rng.normal(size=(bs, T + 1, 2)),
        locs=rng.normal(size=(bs, N, T + 1, 2)),
    )
    batch = {k: torch.from_numpy(v.astype(f32)).to(dev)
             for k, v in arrays.items()}
    batch.update(
        lidar_valid=torch.ones((bs, max_points), dtype=torch.bool,
                               device=dev),
        cmds=torch.zeros((bs,), dtype=torch.int32, device=dev),
        nxps=torch.zeros((bs, 2), device=dev),
        bras=torch.zeros((bs,), dtype=torch.int32, device=dev),
        oris=torch.zeros((bs, N), device=dev),
        typs=torch.ones((bs, N), dtype=torch.int32, device=dev))
    return batch


def distill_setup(batch_size: int = 4, max_points: int = 16384,
                  device=None, seed: int = 0, cfg: LAVConfig = None,
                  v2: bool = True, mode: str = "full", lr: float = 3e-4,
                  compute_dtype=None, remat: bool = False):
    """The v2 distillation step at full width (`v2_config()` unless `cfg`)
    with weights from `seed`, Adam(lr) and a `make_batch` batch, on
    `device` (default the card; raises without one unless 'cpu'), in
    `compute_dtype` and with `remat` (`make_full_train_step`).  Returns
    (step, models, optimizer, batch, gen, cfg), gen the CPU generator the
    step draws its noise from (seeded with seed + 1)."""
    dev = resolve_device(device)
    cfg = cfg or v2_config()
    models = distill_models(cfg, torch.Generator().manual_seed(seed)).to(dev)
    optimizer = adam(models, lr)
    batch = make_batch(cfg, batch_size, max_points, seed, dev)
    step = make_full_train_step(cfg, v2=v2, mode=mode,
                                compute_dtype=compute_dtype, remat=remat)
    return (step, models, optimizer, batch,
            torch.Generator().manual_seed(seed + 1), cfg)
