"""The data mesh: data-parallel training over `torch.distributed`
(counterpart of `lav_tpu/parallel/mesh.py`).

lav_tpu replicates the params over a 1-D `data` mesh and shards the
batch; `jax.jit` then computes the global batch's function, XLA inserting
the reductions.  The port runs one process a device (`torchrun`), each
with the params replicated and its rows of the global batch, and keeps
that semantics: a step on N ranks computes the one-process step on the
same global batch.  Where a naive DDP would differ, the steps reduce over
the mesh that `reducing(mesh)` makes active:

  * train-mode BatchNorm (`nn/layers.py`) takes the per-channel sums and
    counts over every rank (the mean first, then the squared deviations);
  * the losses (`models/losses.py`, `batch_mean` / `batch_sum`) take each
    mean over the global batch, so a ratio of means is the global ratio;
  * random draws (noise, dropout masks) are drawn for the global batch
    from the seeded generators every rank holds and cut to the rank's
    rows (`local_rows`);
  * the backward seeds loss / N on every rank; `batch_sum`'s backward
    sums the gradient over the ranks, and `allreduce_grads` sums the
    parameters' gradients, which gives every rank the global batch's
    gradient (train/distill.py::optimizer_step).

Every rank builds the whole global batch from the seeded loader and keeps
its rows (`local_rows`), as lav_tpu's multi-host loader builds it on
every host: the datasets draw their jitter in sample order.

The process group starts from torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) or from an
explicit address: NCCL on the card, gloo on the CPU (or where asked, such
as two ranks that share one card, which NCCL refuses).  Rank r's device
is `cuda:LOCAL_RANK`.  lav_tpu's hybrid (dcn, data) mesh is a TPU
topology tactic that is not ported: NCCL picks its own hierarchy.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import torch


class DataMesh(NamedTuple):
    """This process's place in the data mesh."""
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str


_ACTIVE: Optional[DataMesh] = None


def init_data_mesh(device="cuda", backend: Optional[str] = None,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world: Optional[int] = None) -> DataMesh:
    """Start (or join) the process group and return this rank's mesh.
    Rank and world come from the arguments, else from torchrun's
    environment; `init_method` defaults to `env://`.  device 'cuda' gives
    `cuda:LOCAL_RANK` (made the current device; 'cuda:i' gives device i,
    for ranks that share a card), 'cpu' the CPU; backend
    defaults to NCCL on the card and gloo on the CPU."""
    import torch.distributed as dist

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    local = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_mesh: a CUDA device was requested "
                               "but torch.cuda.is_available() is False")
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world, **kw)
    return DataMesh(dist.get_rank(), dist.get_world_size(), local, dev,
                    backend)


def close_data_mesh() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def launched() -> bool:
    """Whether this process was started as one rank of several
    (torchrun's WORLD_SIZE above 1)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


@contextlib.contextmanager
def reducing(mesh: Optional[DataMesh]):
    """Make `mesh` the one the train steps reduce over meanwhile (None:
    one process, no reduction).  A mesh of one rank reduces nothing
    either: its step is the one-process step, bit for bit (a mean over
    the batch and a sum over it divided by its size round differently on
    the card)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.world > 1 else None
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def active() -> Optional[DataMesh]:
    return _ACTIVE


def world() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.world


def _all_reduce(x, mesh: DataMesh):
    """Sum of x over the ranks, as a new tensor (gloo reduces on the CPU,
    so a tensor on the card goes there and back)."""
    import torch.distributed as dist

    out = x.detach().clone()
    if mesh.backend == "gloo" and out.is_cuda:
        host = out.cpu()
        dist.all_reduce(host)
        return host.to(out.device)
    dist.all_reduce(out)
    return out


class _BatchSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is summed over the ranks too."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, _ACTIVE)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, _ACTIVE)


def batch_sum(x):
    """x, a sum over this rank's rows, summed over the mesh (x itself
    without one)."""
    return x if _ACTIVE is None else _BatchSum.apply(x)


def batch_mean(x):
    """The mean of x, which leads with this rank's rows, over the global
    batch: x.mean() without a mesh (every rank holds as many rows)."""
    if _ACTIVE is None:
        return x.mean()
    return batch_sum(x.sum()) / (x.numel() * _ACTIVE.world)


def local_rows(tree, mesh: Optional[DataMesh] = None):
    """This rank's rows of every tensor of `tree` (a tensor, a dict, or a
    list or tuple of them), each leading with the global batch; the tree
    itself without a mesh."""
    mesh = mesh or _ACTIVE
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: local_rows(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_rows(v, mesh) for v in tree)
    n = tree.shape[0]
    if n % mesh.world:
        raise ValueError(f"local_rows: {n} rows over {mesh.world} ranks")
    per = n // mesh.world
    return tree[mesh.rank * per:(mesh.rank + 1) * per]


def global_rows(n_local: int) -> int:
    """The global batch's rows for `n_local` rows a rank."""
    return n_local * world()


def broadcast_params(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Rank 0's parameters and buffers on every rank."""
    import torch.distributed as dist

    for t in list(module.parameters()) + list(module.buffers()):
        if mesh.backend == "gloo" and t.is_cuda:
            host = t.detach().cpu()
            dist.broadcast(host, 0)
            t.data.copy_(host)
        else:
            dist.broadcast(t.data, 0)


def allreduce_grads(module: torch.nn.Module, mesh: DataMesh) -> None:
    """Sum every parameter's gradient over the mesh (one flat buffer)."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
