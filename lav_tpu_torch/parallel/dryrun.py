"""Data-parallel steps against the one-process step (the port's
counterpart of `__graft_entry__.dryrun_multichip`).

    python3 -m lav_tpu_torch.parallel.dryrun --world 4  # 4 cards, NCCL
    python3 -m lav_tpu_torch.parallel.dryrun --device cpu  # 2 CPU ranks, gloo

Each case builds a train step with weights, batch and generators from a
seed (every rank the same global batch), runs `steps` steps on this
rank's rows under `parallel.reducing`, and returns each step's metrics,
gradients and buffers (BatchNorm's running statistics) and every
parameter and buffer after the last step.  `spawn` runs a case
on `world` ranks, each a process of its own (the `spawn` start method)
joined to a process group at tcp://localhost:<free port>, with a join
timeout: a rank that hangs is killed and the call raises.  `dryrun`
holds the ranks' results against the same case run in this process
without a process group, at `RTOL`, and every rank's parameters after the
last step to rank 0's, bit for bit.  One rank under the process group
gives the one-process step bit for bit (a mesh of one rank reduces
nothing; tests/test_torch_parallel.py).
Two ranks add their sums in another order, and at tiny_config the step
amplifies that: train-mode BatchNorm over small maps turns it into up to
1e-4 of a gradient leaf in the first step (taking the global BN sums in
f64 instead moved leaves by 1%), and by 1-7% in the second, whose noise
draws give a worse-conditioned instance (measured with a zero update in
between, so not through the parameters); Adam's first update, about lr *
sign(g), turns the rounding of a gradient near 0 into a step of lr.  So
the first step is held tight and the second by its loss.

Cases: "distill" (the v2 distillation step, `train/distill.py`) and
"bev" (the v2 BEV planner step with its train-mode BatchNorm,
`train/privileged.py`), at tiny_config() on the card unless given
another config and device; "cli" (`train/cli.py`'s main on the given
arguments, returning what rank 0 logged); "cases" (several of them in
one process).
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
import time

import torch

from lav_tpu_torch import parallel

# step 1: loss, grad_norm, the gradient leaves (the L2 norm of every
# leaf's difference over grad_norm) and the buffers (the L2 norm of the
# differences over the buffers'); step 2: the loss (relative)
RTOL = dict(loss=1e-5, grad_norm=1e-4, grads=1e-3, buffers=1e-5,
            loss_2=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _steps(mesh, setup, steps: int) -> dict:
    from lav_tpu_torch.utils import native

    step, models, opt, batch, gen, _ = setup
    native.reset_launches()
    if mesh is not None:
        parallel.broadcast_params(models, mesh)
        batch = parallel.local_rows(batch, mesh)
    metrics, grads, buffers = [], [], []
    with parallel.reducing(mesh):
        for _ in range(steps):
            m = step(models, opt, batch, gen)
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({n: p.grad.detach().cpu().clone()
                          for n, p in models.named_parameters()
                          if p.grad is not None})
            buffers.append({n: b.detach().cpu().clone()
                            for n, b in models.named_buffers()})
    params = {n: p.detach().cpu().clone()
              for n, p in list(models.named_parameters())
              + list(models.named_buffers())}
    return dict(metrics=metrics, grads=grads, buffers=buffers, params=params,
                launches={k: v for k, v in native.LAUNCHES.items() if v})


def distill_case(mesh=None, batch_size: int = 8, max_points: int = 64,
                 steps: int = 2, device="cuda", cfg=None, seed: int = 0):
    """The v2 distillation step on a global batch of `batch_size`."""
    from lav_tpu_torch.config import tiny_config
    from lav_tpu_torch.train.distill import distill_setup

    dev = mesh.device if mesh is not None else torch.device(device)
    setup = distill_setup(batch_size, max_points, device=dev, seed=seed,
                          cfg=cfg or tiny_config())
    return _steps(mesh, setup, steps)


def bev_case(mesh=None, batch_size: int = 8, steps: int = 2, device="cuda",
             cfg=None, seed: int = 0):
    """The v2 BEV planner step on a global batch of `batch_size`."""
    from lav_tpu_torch.config import tiny_config
    from lav_tpu_torch.train.privileged import bev_setup

    dev = mesh.device if mesh is not None else torch.device(device)
    setup = bev_setup(batch_size, device=dev, seed=seed,
                      cfg=cfg or tiny_config(), v2=True)
    return _steps(mesh, setup, steps)


def cli_case(mesh=None, argv=()):
    """`train.cli.main(argv)` on this rank -> the metrics rank 0 logged
    (its `metrics.jsonl`, read back; None on the other ranks)."""
    import json

    from lav_tpu_torch.train import cli

    run = cli.main(list(argv))
    if mesh is not None and mesh.rank != 0:
        return None
    save = argv[argv.index("--save-dir") + 1]
    path = os.path.join(save, run.stage.name, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def cases_case(mesh=None, specs=()):
    """Several cases in one process: specs [(name, kwargs), ...] ->
    {name: its result}."""
    return {name: CASES[name](mesh, **kw) for name, kw in specs}


CASES = {"distill": distill_case, "bev": bev_case, "cli": cli_case,
         "cases": cases_case}


def _rank_main(rank: int, world: int, port: int, case, device, backend,
               out: str, kwargs: dict, deterministic: bool) -> None:
    torch.set_num_threads(1)
    if deterministic:   # before cuBLAS starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None
    if world:
        mesh = parallel.init_data_mesh(
            device=device, backend=backend, rank=rank, world=world,
            init_method=f"tcp://localhost:{port}")
    try:
        fn = CASES[case] if isinstance(case, str) else case
        torch.save(fn(mesh, **kwargs), f"{out}.{rank}")
    finally:
        parallel.close_data_mesh()


def spawn(case, world: int = 2, device="cuda", backend=None,
          timeout: float = 300.0, deterministic: bool = False,
          **kwargs) -> list:
    """Run `case` (a name of CASES, or a function (mesh, **kwargs) -> a
    picklable result, importable by name) on `world` ranks; returns each
    rank's result.  world 0 runs it in one process without a process
    group (mesh None).  `deterministic` turns on PyTorch's deterministic
    algorithms (cuDNN's among them) in each process, with TF32 off.
    Raises if a rank fails or does not end within `timeout` seconds
    (every rank is then killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, port, case, device, backend, out, kwargs,
            deterministic)) for r in range(max(world, 1))]
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} did not end within "
                               f"{timeout} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks failed (rank, exit code): {failed}")
        return [torch.load(f"{out}.{r}") for r in range(len(procs))]


def worst(got: dict, want: dict) -> dict:
    """Relative differences: the first step's loss, grad_norm, gradients
    (the L2 norm of every leaf's difference over grad_norm) and buffers
    (the L2 norm of every floating buffer's difference over theirs), and
    the second step's loss."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def l2(tree):
        return sum(float(t.double().norm()) ** 2 for t in tree) ** 0.5

    (g1, *g_rest), (w1, *w_rest) = got["metrics"], want["metrics"]
    grads = l2(got["grads"][0][n] - p for n, p in want["grads"][0].items())
    bufs = [(got["buffers"][0][n], b) for n, b in want["buffers"][0].items()
            if b.is_floating_point()]
    out = dict(loss=rel(g1["loss"], w1["loss"]),
               grad_norm=rel(g1["grad_norm"], w1["grad_norm"]),
               grads=grads / w1["grad_norm"],
               buffers=l2(g - b for g, b in bufs)
               / max(l2(b for _, b in bufs), 1e-30))
    if w_rest:
        out["loss_2"] = rel(g_rest[0]["loss"], w_rest[0]["loss"])
    return out


def dryrun(world: int = 2, cases=("distill", "bev"), device="cuda",
           backend=None, rtol: dict = RTOL, timeout: float = 300.0,
           **kwargs) -> dict:
    """Each case on `world` ranks against one process; prints each rank's
    worst relative differences and raises past `rtol` or where the ranks'
    parameters differ.  -> {case: [worst per rank]}."""
    res = {}
    for case in cases:
        want = CASES[case](None, device=device, **kwargs)
        ranks = spawn(case, world, device=device, backend=backend,
                      timeout=timeout, **kwargs)
        res[case] = [worst(r, want) for r in ranks]
        for r, w in enumerate(res[case]):
            print(f"[dryrun] {case}, rank {r} of {world}: worst relative "
                  f"difference to one process {w}", flush=True)
            if any(w[k] > rtol[k] for k in w):
                raise AssertionError(f"{case}: rank {r} differs from one "
                                     f"process beyond {rtol}: {w}")
            if not all(torch.equal(p, ranks[0]["params"][n])
                       for n, p in ranks[r]["params"].items()):
                raise AssertionError(f"{case}: rank {r}'s parameters differ "
                                     "from rank 0's")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:LOCAL_RANK a rank, NCCL) or cpu (gloo)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--cases", default="distill,bev")
    args = ap.parse_args(argv)
    dryrun(args.world, tuple(args.cases.split(",")), args.device,
           args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
