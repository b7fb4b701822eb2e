"""Readings for the limits of `correct`: run a cell once per seed in one
process and print each run's result line.

    python3 -m lavbench.readings --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control | --fault unchanged|half|altered]

With `--control` the reference one precision below the configuration's
stands in the program's place (int8 convs in int4; f32 with TF32 on);
with `--fault` the program's step is broken underneath (`faults.py`).
Their numbers must fail the limits.  The benchmark's own runs never run
the control.
"""

import argparse
import contextlib
import sys

from lavbench import faults, manifest, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lavbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    loop = manifest.Cell(args.workload).traffic["loop"]
    worst = 0
    for seed in args.seeds.split(","):
        with (faults.planted(args.fault, loop) if args.fault
              else contextlib.nullcontext()):
            rc = run.main(["--workload", args.workload, "--seed", seed,
                           "--seconds", str(args.seconds), "--trace", "0"],
                          control=args.control, readings=True)
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
