"""Metrics logger: wandb when asked for and installed, JSONL always
(counterpart of `lav_tpu/utils/logging.py`).

Covers LAV's Logger surface (lav/utils/logger.py): per-stage scalar
logging, gradient norms, checkpoint registration, with a local JSONL and
npz sink so that training is observable without a network.  Values may be
tensors on the card: `log` is where they become host numbers, so a train
loop that logs every n-th step waits for the device only then.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16 \
            else v.detach().cpu().numpy()
    return np.asarray(v)


def _have_wandb() -> bool:
    try:
        import wandb  # noqa: F401
    except Exception:
        return False
    return True


class Logger:
    def __init__(self, project: str, save_dir: Optional[str] = None,
                 use_wandb: bool = False, config: Optional[dict] = None):
        self.project = project
        self.use_wandb = use_wandb and _have_wandb()
        if self.use_wandb:
            import wandb

            wandb.init(project=project, config=config or {})
            self.save_dir = wandb.run.dir
        else:
            self.save_dir = save_dir or os.path.join(
                "runs", project, time.strftime("%Y%m%d_%H%M%S"))
            os.makedirs(self.save_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.save_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict):
        scalars = {}
        arrays = {}
        for k, v in metrics.items():
            v = _host(v)
            if v.ndim == 0:
                scalars[k] = float(v)
            else:
                arrays[k] = v
        rec = {"step": step, "t": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if arrays:
            np.savez_compressed(
                os.path.join(self.save_dir, f"diag_{step:08d}.npz"), **arrays)
        if self.use_wandb:
            import wandb

            wandb.log(scalars, step=step)
        return rec

    def log_gradients(self, step: int, grads, max_leaves: int = 256):
        """Per-leaf gradient norms and the global norm of `grads`, a nested
        dict of arrays or tensors, into the same scalar sinks (the
        analogue of LAV's wandb.watch)."""
        flat = {}

        def walk(tree, path):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    walk(tree[k], f"{path}/{k}" if path else k)
            else:
                flat[path] = _host(tree)

        walk(grads, "")
        sq = 0.0
        scalars = {}
        for i, (path, g) in enumerate(flat.items()):
            norm = float(np.linalg.norm(g.astype(np.float64)))
            sq += norm * norm
            if i < max_leaves:
                scalars[f"grad/{path}"] = norm
        scalars["grad/global_norm"] = float(np.sqrt(sq))
        return self.log(step, scalars)

    def save_file(self, path: str):
        if self.use_wandb:
            import wandb

            wandb.save(path)

    def close(self):
        self._jsonl.close()
        if self.use_wandb:
            import wandb

            wandb.finish()
