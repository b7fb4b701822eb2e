"""Training CLI: the staged pipeline's entry point (counterpart of
`lav_tpu/train/cli.py`).

LAV trains in stages, bev -> seg -> bra -> paint -> full
(`python -m lav_tpu_torch.train.paint` is the paint pass).  Each stage has
lav_tpu's defaults (bev batch 512 (v2 256) x 160 epochs, seg 256 x 1, bra
52 x 10, full 32 x 64; lr 3e-4, seed 2021), its StepLR schedule (bev:
halved every 32 epochs, full: every 16), a checkpoint every
--num-per-save epochs and, in the bev stage, the v2 other_weight ramp
1 - 0.8^(it / 4000).

    python -m lav_tpu_torch.train.cli bev  --config-path config.yaml
    python -m lav_tpu_torch.train.cli full --config-path config_v2.yaml \
        --v2 --motion-only
    python -m lav_tpu_torch.train.cli seg --device cpu   # without a card

The stages run on the card unless --device says otherwise
(`utils/device.py`).  Launched as several ranks (`torchrun
--nproc_per_node N -m lav_tpu_torch.train.cli ...`), a stage trains
data-parallel over them (`parallel/mesh.py`): each rank on
`cuda:LOCAL_RANK` (NCCL; gloo with --device cpu), every rank builds the
global batch from the seeded loader and keeps its rows, and a step
computes the one-process step on the global batch.  The batch size must
divide over the ranks (lav_tpu's check and message).  Only rank 0 logs
and saves checkpoints; every rank resumes from the same file.
--dcn-slices N asks for lav_tpu's hybrid (dcn, data) mesh: the world
size must be a multiple of N, and training is the same data parallelism
(NCCL picks its own hierarchy).  --grad-accum N is
optax.MultiSteps (`train/distill.py::MultiSteps`): Adam on the mean of N
micro-batch gradients every N-th micro-step, the schedule counting
updates.  Kept from lav_tpu on purpose: `steps_per_epoch` of the schedule
comes from the stage's default batch, not from --batch-size.

Resume (--resume) restores params, optimizer state (the schedule's count
and a partial gradient mean included), epoch and iteration.  As in
lav_tpu, the loader and the draws start again from --seed, so a resumed
run replays the first epoch's shuffle, jitter and noise: it is not the
continuation of an unbroken run.

The draws: the bev and full steps take their noise from a CPU
torch.Generator seeded with --seed (`planner.draw_noise`,
`draw_bev_noise`), ERFNet's dropout from a generator on the device seeded
with --seed.  They do not reproduce JAX's key splits, so the port and
lav_tpu draw differently from the same seed.  The metrics stay on the
device; they become host numbers only in the steps that log them.

`main(argv)` returns a `TrainRun`: the models, the optimizer, the
position and the loop's timings (`StepClock`).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, NamedTuple, Optional

import torch

from lav_tpu_torch import parallel
from lav_tpu_torch.config import LAVConfig, load_config, v1_config, v2_config
from lav_tpu_torch.data.datasets import get_dataset
from lav_tpu_torch.data.loader import DataLoader
from lav_tpu_torch.models.planner import BEVPlanner
from lav_tpu_torch.models.rgb import BrakeModel, SegModel
from lav_tpu_torch.parallel import DataMesh
from lav_tpu_torch.train.checkpoints import (
    load_checkpoint, load_params, save_checkpoint, snapshot,
)
from lav_tpu_torch.train.distill import (
    MultiSteps, adam, distill_models, make_full_train_step,
)
from lav_tpu_torch.train.privileged import (
    make_bev_train_step, make_bra_train_step, make_seg_train_step, step_lr,
)
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.logging import Logger
from lav_tpu_torch.utils.weights import load_torch_state_dict

STAGES = ("bev", "seg", "bra", "full")


def _common_args(p: argparse.ArgumentParser):
    p.add_argument("--config-path", default=None)
    p.add_argument("--v2", action="store_true")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--num-epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--num-per-log", type=int, default=100)
    p.add_argument("--num-per-save", type=int, default=1)
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--log-wandb", action="store_true")
    p.add_argument("--resume", default=None,
                   help="checkpoint path for resume (params + optimizer "
                        "state + epoch/iteration)")
    p.add_argument("--imagenet-weights", default="",
                   help="torchvision resnet18 state_dict .pth for the "
                        "brake net's ImageNet-pretrained backbone")
    p.add_argument("--dcn-slices", type=int, default=0,
                   help="slices of lav_tpu's hybrid mesh: the ranks' "
                        "number must be a multiple of it; trains data-"
                        "parallel over the ranks as without it")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches before "
                        "each optimizer update (effective batch = "
                        "batch-size * N)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")


def _load_cfg(args) -> LAVConfig:
    if args.config_path:
        return load_config(args.config_path)
    return v2_config() if args.v2 else v1_config()


def _other_weight_ramp(it: int, beta: float = 0.8) -> float:
    return 1.0 - beta ** (it / 4000.0)


def _seeded(seed: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Stage(NamedTuple):
    """A stage ready to train: `run(batch, it, **draws)` takes one step
    (draws: the step's `noise` or `masks`, else drawn from the stage's
    generators) and returns its metrics."""
    name: str
    cfg: LAVConfig
    models: torch.nn.Module
    optimizer: MultiSteps
    dataset: object
    run: Callable
    defaults: dict
    device: torch.device


def _optimizer(models, args, steps_per_epoch: Optional[int] = None,
               step_size_epochs: Optional[int] = None) -> MultiSteps:
    """Adam(args.lr) under --grad-accum, with lav_tpu's StepLR schedule
    where the stage has one."""
    opt = adam(models, args.lr)
    sched = (None if steps_per_epoch is None else
             step_lr(opt, args.lr, steps_per_epoch, step_size_epochs))
    return MultiSteps(opt, args.grad_accum, sched)


def setup_bev(args) -> Stage:
    cfg, dev = _load_cfg(args), resolve_device(args.device)
    ds = get_dataset("temporal_bev" if args.v2 else "bev", cfg)
    models = BEVPlanner(cfg, _seeded(args.seed)).to(dev)
    defaults = dict(bs=256 if args.v2 else 512, epochs=160)
    steps_per_epoch = max(len(ds) // defaults["bs"], 1)
    opt = _optimizer(models, args, steps_per_epoch, 32)
    step, gen = make_bev_train_step(cfg, v2=args.v2), _seeded(args.seed)

    def run(batch, it, noise=None):
        return step(models, opt, batch, gen, noise=noise,
                    other_weight=_other_weight_ramp(it))

    return Stage("bev", cfg, models, opt, ds, run, defaults, dev)


def setup_seg(args) -> Stage:
    cfg, dev = _load_cfg(args), resolve_device(args.device)
    ds = get_dataset("seg", cfg)
    models = SegModel(len(cfg.seg_channels), _seeded(args.seed)).to(dev)
    opt = _optimizer(models, args)
    step, gen = make_seg_train_step(cfg), _seeded(args.seed, dev)

    def run(batch, it, masks=None):
        return step(models, opt, batch, gen=gen, masks=masks)

    return Stage("seg", cfg, models, opt, ds, run, dict(bs=256, epochs=1),
                 dev)


def _imagenet_sd(cfg, args):
    """The ImageNet-pretrained resnet18 backbone weights (LAV's rgb.py
    pretrained=True, which torchvision downloads): a local torchvision
    state_dict .pth from --imagenet-weights or LAV_IMAGENET_RESNET18;
    nothing is downloaded."""
    if not (cfg.imagenet_pretrained or args.imagenet_weights):
        return None
    path = args.imagenet_weights or os.environ.get("LAV_IMAGENET_RESNET18", "")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "imagenet_pretrained is set but no weights file found: pass "
            "--imagenet-weights /path/to/torchvision_resnet18.pth (or set "
            "LAV_IMAGENET_RESNET18); nothing is downloaded")
    return load_torch_state_dict(path)


def setup_bra(args) -> Stage:
    cfg, dev = _load_cfg(args), resolve_device(args.device)
    ds = get_dataset("bra", cfg)
    version = 2 if args.v2 else 1
    models = BrakeModel(version, _seeded(args.seed),
                        imagenet_sd=_imagenet_sd(cfg, args)).to(dev)
    opt = _optimizer(models, args)
    step = make_bra_train_step(cfg, version=version)

    def run(batch, it):
        return step(models, opt, batch)

    return Stage("bra", cfg, models, opt, ds, run, dict(bs=52, epochs=10),
                 dev)


def setup_full(args) -> Stage:
    cfg, dev = _load_cfg(args), resolve_device(args.device)
    ds = get_dataset("temporal_lidar_painted" if args.v2 else
                     "lidar_painted", cfg)
    models = distill_models(cfg, _seeded(args.seed))
    # the stage pointer: the teacher from the bev stage's checkpoint
    if cfg.bev_model_dir and os.path.exists(cfg.bev_model_dir):
        load_params(cfg.bev_model_dir, models["uniplanner"].bev_planner)
    models = models.to(dev)
    mode = ("perceive_only" if args.perceive_only
            else "motion_only" if args.motion_only else "full")
    defaults = dict(bs=32, epochs=64)
    steps_per_epoch = max(len(ds) // defaults["bs"], 1)
    opt = _optimizer(models, args, steps_per_epoch, 16)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    step = make_full_train_step(cfg, v2=args.v2, mode=mode,
                                compute_dtype=dtype, remat=args.remat)
    gen = _seeded(args.seed)

    def run(batch, it, noise=None):
        return step(models, opt, batch, gen, noise=noise)

    return Stage("full", cfg, models, opt, ds, run, defaults, dev)


SETUPS = {"bev": setup_bev, "seg": setup_seg, "bra": setup_bra,
          "full": setup_full}


class StepClock:
    """Each step's time without waiting on the device: CUDA events around
    it on the card, read once at the end; the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: list = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        self._marks.append([self._mark(), None])

    def stop(self):
        self._marks[-1][1] = self._mark()

    def step_ms(self) -> list:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in self._marks]
        if self._marks:
            self._marks[-1][1].synchronize()
        return [a.elapsed_time(b) for a, b in self._marks]


class TrainRun(NamedTuple):
    """What a stage's run leaves: its models and optimizer, the position
    reached, each step's time (`StepClock`) and the ms it waited on the
    loader, (samples, seconds) per epoch (the host's clock from the
    epoch's first fetch to its last step's end) and the first batch's
    dtypes."""
    stage: Stage
    epoch: int
    it: int
    step_ms: list
    wait_ms: list
    epochs: list
    batch_dtypes: dict


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(stage: Stage, args, mesh: Optional[DataMesh] = None) -> TrainRun:
    """The stage's loop: resume, then epochs of loader batches through
    `stage.run`, logging every --num-per-log steps and saving every
    --num-per-save epochs; data-parallel over `mesh` when given (every
    rank its rows of the global batch; rank 0 logs and saves)."""
    name, models, opt, dev = stage.name, stage.models, stage.optimizer, \
        stage.device
    bs = args.batch_size or stage.defaults["bs"]
    epochs = args.num_epoch or stage.defaults["epochs"]
    n_dev = 1 if mesh is None else mesh.world
    slices = getattr(args, "dcn_slices", 0)
    if slices and n_dev % slices:
        raise ValueError(f"--dcn-slices {slices}: {n_dev} ranks do not "
                         f"factor into {slices} slices")
    if bs % n_dev:
        raise ValueError(
            f"batch size {bs} is not divisible by the {n_dev}-device data "
            f"mesh; pick a multiple of {n_dev} "
            f"(e.g. --batch-size {-(-bs // n_dev) * n_dev})"
        )
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        parallel.broadcast_params(models, mesh)
    start_epoch, it = 0, 0
    if args.resume:
        snap = load_checkpoint(args.resume, models, opt)
        start_epoch, it = int(snap["epoch"]), int(snap["it"])
        print(f"resumed from {args.resume} at epoch {start_epoch}, it {it}")

    loader = DataLoader(stage.dataset, bs, shuffle=True, seed=args.seed,
                        device=dev)
    logger = (Logger(f"lav_{name}", use_wandb=args.log_wandb,
                     save_dir=os.path.join(args.save_dir, name))
              if lead else None)
    clock, per_epoch, dtypes = StepClock(dev), [], {}
    with parallel.reducing(mesh):
        for epoch in range(start_epoch, epochs):
            t0, n = time.perf_counter(), 0
            for batch in loader:
                if not dtypes:
                    dtypes = {k: v.dtype for k, v in batch.items()}
                clock.start()
                m = stage.run(parallel.local_rows(batch), it)
                clock.stop()
                if it % args.num_per_log == 0 and lead:
                    rec = logger.log(it, m)
                    print(f"[{name}] epoch {epoch} it {it}: "
                          f"loss={rec.get('loss', float('nan')):.4f}")
                it += 1
                n += bs
            _sync(dev)
            per_epoch.append((n, time.perf_counter() - t0))
            if (epoch + 1) % args.num_per_save == 0 and lead:
                path = os.path.join(logger.save_dir, f"{name}_{epoch + 1}")
                save_checkpoint(path, snapshot(models, opt, epoch + 1, it))
                print(f"saved {path}")
    if lead:
        logger.close()
    if it == 0 and epochs > start_epoch:
        raise RuntimeError(
            f"[{name}] trained ZERO steps over {epochs - start_epoch} "
            f"epoch(s): dataset ({len(stage.dataset)} samples) shorter than "
            f"one batch ({bs})?")
    return TrainRun(stage, max(epochs, start_epoch), it, clock.step_ms(),
                    loader.wait_ms, per_epoch, dtypes)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="stage", required=True)
    for stage in STAGES:
        sp = sub.add_parser(stage)
        _common_args(sp)
        if stage == "full":
            sp.add_argument("--perceive-only", action="store_true")
            sp.add_argument("--motion-only", action="store_true")
            sp.add_argument("--dtype", default="float32",
                            choices=["float32", "bfloat16"],
                            help="compute dtype (losses and params stay "
                                 "f32)")
            sp.add_argument("--remat", action="store_true",
                            help="recompute the forwards in the backward "
                                 "pass")
    return p


def main(argv=None) -> TrainRun:
    """Parse `argv` and train the stage: on one device, or data-parallel
    when the process is one of several ranks (torchrun's WORLD_SIZE above
    1) or a process group is running."""
    args = parser().parse_args(argv)
    import torch.distributed as dist

    if not (parallel.launched() or dist.is_initialized()):
        return train(SETUPS[args.stage](args), args)
    started = not dist.is_initialized()
    mesh = parallel.init_data_mesh(device=args.device)
    args.device = str(mesh.device)
    try:
        return train(SETUPS[args.stage](args), args, mesh)
    finally:
        if started:
            parallel.close_data_mesh()


if __name__ == "__main__":
    main()
