"""Plant faults of the data mesh in copies of the package and read what the
2-rank check (`dryrun.worst`) sees of each.

    python3 -m lav_tpu_torch.parallel.faults DEST            # on the card
    python3 -m lav_tpu_torch.parallel.faults DEST --device cpu

For the sound package and for each fault of FAULTS, copies the package
into DEST/<fault>/ (its built kernels too), makes the fault's edit there,
and runs the distillation and BEV steps in processes of their own with
deterministic algorithms: one process without a group and 2 gloo ranks
(on the card, both ranks share cuda:0).  Prints each rank's `dryrun.worst`
against the one process, whether the ranks' parameters and buffers are
equal, and each run's launches, one JSON line a fault.  The tolerances of
the 2-rank checks (`dryrun.RTOL` on the CPU, chip_smoke.py's
PARALLEL_RTOL on the card) lie between the sound reading and the
smallest reading of a fault.  The shapes: tiny_config on the CPU;
chip_smoke.py's phase parallel on the card (v2_config, the distillation
step at B = 4 with 16384 points an item, the BEV step at B = 8).
Nothing under the checkout it runs from is changed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> [(file in the package, text, its replacement)]
FAULTS = {
    "sound": [],
    # train-mode BN statistics over the rank's rows only
    "bn_local_stats": [(
        "nn/layers.py",
        "if parallel.active() is not None:   # statistics",
        "if False:   # statistics")],
    # BN's running statistics updated from the rank's rows only
    "bn_local_running": [(
        "nn/layers.py",
        "(1 - mom) * self.mean + mom * mean,",
        "(1 - mom) * self.mean + mom * xs.mean(dim=axes),")],
    # every batch mean the rank's own, so a ratio of means is per rank
    "ratio_local": [(
        "parallel/mesh.py",
        "    if _ACTIVE is None:\n        return x.mean()",
        "    if True:\n        return x.mean()")],
    # the parameters' gradients not summed over the ranks
    "no_allreduce_grads": [(
        "parallel/mesh.py",
        "    grads = [p.grad for p in module.parameters() if p.grad is not None]",
        "    grads = []")],
}

_CHILD = r'''
import json, sys
import torch
from lav_tpu_torch.parallel import dryrun as D

dev = sys.argv[1]
torch.set_num_threads(1)
if dev == "cuda":
    from lav_tpu_torch.config import v2_config
    cfg = v2_config()
    specs = [("distill", dict(batch_size=4, max_points=16384, cfg=cfg,
                              device=dev)),
             ("bev", dict(batch_size=8, cfg=cfg, device=dev))]
    two_dev = "cuda:0"
else:
    specs = [("distill", dict(device=dev)), ("bev", dict(device=dev))]
    two_dev = dev
solo, = D.spawn("cases", 0, device=dev, deterministic=True, timeout=900,
                specs=specs)
two = D.spawn("cases", 2, device=two_dev, backend="gloo", deterministic=True,
              timeout=900, specs=specs)
out = {}
for case, _ in specs:
    out[case] = [D.worst(r[case], solo[case]) for r in two]
    out[case + "_ranks_equal"] = all(
        torch.equal(p, two[0][case]["params"][n])
        for n, p in two[1][case]["params"].items())
    out[case + "_launches"] = [solo[case]["launches"]] + [
        r[case]["launches"] for r in two]
print("RESULT " + json.dumps(out), flush=True)
'''


def plant(dest: str, name: str) -> str:
    """A copy of the package under dest/name with fault `name` in it;
    returns the directory to put on PYTHONPATH."""
    root = os.path.join(dest, name)
    shutil.rmtree(root, ignore_errors=True)
    pkg = os.path.join(root, "lav_tpu_torch")
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    for path, text, new in FAULTS[name]:
        p = os.path.join(pkg, path)
        with open(p) as f:
            src = f.read()
        if src.count(text) != 1:
            raise ValueError(f"fault {name}: {path} holds {text!r} "
                             f"{src.count(text)} times")
        with open(p, "w") as f:
            f.write(src.replace(text, new))
    return root


def read(dest: str, name: str, device: str) -> dict:
    """The 2-rank readings of the package with fault `name`."""
    root = plant(dest, name)
    r = subprocess.run([sys.executable, "-c", _CHILD, device], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True)
    lines = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    if r.returncode or not lines:
        raise RuntimeError(f"fault {name}: exit {r.returncode}\n"
                           f"{r.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dest", help="a directory for the copies")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    for name in args.faults.split(","):
        print(f"[faults] {name} " + json.dumps(read(args.dest, name,
                                                   args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
