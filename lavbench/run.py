"""Run one cell of the benchmark once and print its result line.

    python3 -m lavbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (`setup_s`, from the start of this process to the first timed
unit) builds the program's kernels, makes the weights and the traffic from
the seed and warms every shape up.  The window then runs ticks or steps
closed loop for `--seconds` on the host clock.  With `--trace 1` a steady
stretch of the window (`trace_units` units, a third of the way in) runs
under `torch.profiler`, and the per-layer metrics are read from it;
otherwise the end-to-end metrics are reported.  After the window the peak
memory is read, the program's state is freed and the reference checks
what the window produced (`correct`); each number compared is printed
beside its limit, on standard error and under `check`, last in the line.
Exit codes: 2 the cell or its files are missing, 3 no card (or too few),
4 JAX or lav_tpu was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lav_tpu")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m lavbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that this benchmark may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None, root=None, device=None, control=False, out=None,
         readings=False):
    """Run a cell; returns the exit code.  `root`, `device` and `control`
    are for the tests and for the readings of the limits: a checkout other
    than this one, a device other than the card (the card's check is then
    skipped), and the reference one precision below in the program's
    place; `readings` prints every number the check computed, compared
    or not."""
    from lavbench import manifest

    args = parse(argv)
    out = out or sys.stdout
    try:
        cell = manifest.Cell(args.workload, root or manifest.ROOT)
    except (OSError, KeyError, ValueError) as e:
        print(f"lavbench: cannot read cell {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"lavbench: cell {cell.name} needs {cell.chips} CUDA "
                  "device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 3
        device = "cuda"
    cache = os.path.join(cell.root, ".lavbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    torch.manual_seed(args.seed)
    started = time.perf_counter() - START
    drv = cell.loop().Loop(cell.config, cell.traffic, args.seed, device)
    _sync(torch, device)
    setup_s = time.perf_counter() - START
    phases = dict(start=started, **drv.phases.spent)
    print("setup phases " + json.dumps({k: round(v, 3)
                                        for k, v in phases.items()}),
          file=sys.stderr)

    times, traced, summary = [], None, None
    n_trace = cell.traffic["trace_units"] if args.trace else 0
    t_win = time.perf_counter()
    while True:
        if n_trace and traced is None and \
                time.perf_counter() - t_win >= args.seconds / 3:
            traced, prof = _traced(torch, device, drv, n_trace, times)
        t0 = time.perf_counter()
        drv.unit_call()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - t_win >= args.seconds:
            break
    if n_trace and traced is None:
        traced, prof = _traced(torch, device, drv, n_trace, times)
    _sync(torch, device)
    window_s = time.perf_counter() - t_win
    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if traced is not None:
        from lavbench import trace as TR
        summary = TR.summarize(TR.chrome_trace(prof), traced[0] * 1e6,
                               n_trace, drv.prefix)
        del prof
    drv.release()
    numbers, least = drv.check(control)
    if readings and hasattr(drv, "witness"):
        numbers.update(drv.witness())
    bad = forbidden_modules()
    if bad:
        print(f"lavbench: modules {bad} were loaded", file=sys.stderr)
        return 4

    units = {m["name"]: m["unit"] for m in
             cell.bench["end_to_end"] + cell.bench["per_layer"]}
    metrics = {}
    if args.trace:
        untimed = traced[1]
        plain = [t for k, t in enumerate(times) if k not in untimed]
        ctx = dict(summary=summary, least=least, memory_peak_bytes=peak,
                   unit_s=sum(plain) / max(len(plain), 1))
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        e2e = drv.e2e(times, window_s)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": units[m["name"]]}
    limits = cell.limits["limits"]
    check = {k: {"value": numbers.get(k), "limit": limits[k]}
             for k in limits}
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in check.values())
    if readings:
        print("readings " + json.dumps(numbers), file=sys.stderr)
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell.chips if is_cuda else 0,
           "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": len(times), "failed": 0,
            "metrics": metrics, "device": dev}
    if summary is not None:
        from lavbench import trace as TR
        dev["busy_s"] = summary["busy_us"] / 1e6
        dev["window_s"] = summary["window_us"] / 1e6
        line["breakdown"] = TR.breakdown(summary)
    line["check"] = check
    for k, v in check.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), file=out, flush=True)
    return 0


def _traced(torch, device, drv, n, times):
    """Run `n` units under the profiler; ((their wall seconds, indices in
    `times`), the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    _sync(torch, device)
    prof.start()
    first = len(times)
    t0 = time.perf_counter()
    for _ in range(n):
        a = time.perf_counter()
        drv.unit_call()
        times.append(time.perf_counter() - a)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    prof.stop()
    return (wall, set(range(first, len(times)))), prof


if __name__ == "__main__":
    sys.exit(main())
