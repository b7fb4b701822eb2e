"""Dataset conversion: LAV LMDB trajectories -> native .lavpack packs.

    python -m lav_tpu_torch.data.convert --src /data/lav --dst /data/lav_pack

Each trajectory directory (an LMDB environment) becomes one mmap-able
.lavpack file readable by the native store (lav_tpu_torch/data/lavpack.py).
Requires the lmdb package for reading the source.
"""

from __future__ import annotations

import argparse
import glob
import os


def convert_lmdb_dir(src: str, dst: str) -> str:
    import lmdb  # gated: only needed for reading the released dataset

    from lav_tpu_torch.data.lavpack import LavPackWriter

    env = lmdb.open(src, readonly=True, lock=False, readahead=False)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    w = LavPackWriter(dst)
    with env.begin() as txn:
        for k, v in txn.cursor():
            w.put(bytes(k), bytes(v))
    w.finish()
    env.close()
    return dst


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="dir of LMDB trajectory dirs")
    p.add_argument("--dst", required=True, help="output dir for .lavpack")
    args = p.parse_args()
    os.makedirs(args.dst, exist_ok=True)
    n = 0
    for traj in sorted(glob.glob(os.path.join(args.src, "*"))):
        if not os.path.isdir(traj):
            continue
        if not os.path.exists(os.path.join(traj, "data.mdb")):
            continue
        name = os.path.basename(traj.rstrip("/"))
        out = os.path.join(args.dst, name + ".lavpack")
        convert_lmdb_dir(traj, out)
        n += 1
        print(f"converted {name}")
    print(f"{n} trajectories -> {args.dst}")


if __name__ == "__main__":
    main()
