"""The agent tick's FLOPs, memory and, optionally, its device time by
kernel (counterpart of `lav_tpu/utils/bench_profile.py`, on
`agent/setup.py::v2_agent_setup` in bf16).

    python -m lav_tpu_torch.utils.bench_profile [--quant mxu] [--trace]
        [--dump table.json] [--num-ego 16] [--max-points 8192]
        [--device cpu]

Runs on the card unless `--device cpu` is given.  In place of XLA's cost
and memory analyses it prints {"num_ego", "gflops_per_tick",
"gbytes_per_tick", "gflops_per_ego_step"} (FLOPs of one tick as
`torch.utils.flop_counter.FlopCounterMode` counts them, which leaves out
the port's own kernels; no analysis counts bytes, so gbytes_per_tick is
null) and {"temp_mb", "argument_mb", "output_mb"}: the peak allocated
over one tick above what was allocated before it (null on the CPU, which
has no such counter), and the sizes of the state and observation
tensors, and of the tick's outputs.  `--trace` profiles 4 ticks with
`torch.profiler` (`roofline.profile_device`: on the card, a trace with
no kernel is taken again, then raises) and prints device ms a tick by op
class (`roofline.per_class_ms`) and the 40 (kernel, stage) pairs that
take the most, each with its class; the stage is the `agent/*`
`record_function` label around the kernel's launch.  Its result adds
"classes_ms" and "hand_kernels", {name: ms a tick} of the port's own
kernels.  `--dump` writes every pair's row as JSON.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils import _pytree

from lav_tpu_torch.agent.setup import v2_agent_setup
from lav_tpu_torch.utils import roofline
from lav_tpu_torch.utils.device import resolve_device
from lav_tpu_torch.utils.profiling import card_line, synchronize

TRACE_TICKS = 4
IMG_HW = (288, 256)      # the three cameras' images


def tensor_mb(tree) -> float:
    return sum(x.numel() * x.element_size()
               for x in _pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor)) / 1e6


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace", action="store_true")
    p.add_argument("--max-points", type=int, default=8192)
    p.add_argument("--num-ego", type=int, default=16)
    p.add_argument("--quant", default=None,
                   help="int8 scope of v2_agent_setup ('mxu' or 'all')")
    p.add_argument("--dump", default=None,
                   help="write the full per-kernel table (ms, name, class, "
                        "stage) as JSON to this path")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {card_line(dev)}", flush=True)

    step, models, state, obs, _ = v2_agent_setup(
        max_points=args.max_points, num_ego=args.num_ego, img_hw=IMG_HW,
        device=dev, compute_dtype=torch.bfloat16, quant=args.quant)
    if args.quant:
        print(f"quant: {args.quant}")
    E = args.num_ego
    out = step(models, state, obs)          # warm
    synchronize()
    flops = roofline.count_flops(step, models, state, obs)
    results = {"num_ego": E,
               "gflops_per_tick": round(flops / 1e9, 2),
               "gbytes_per_tick": None,
               "gflops_per_ego_step": round(flops / 1e9 / E, 2)}
    print(json.dumps(results), flush=True)

    temp_mb = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        out = step(models, state, obs)
        synchronize()
        temp_mb = round((torch.cuda.max_memory_allocated(dev) - before)
                        / 1e6, 1)
    mem = {"temp_mb": temp_mb,
           "argument_mb": round(tensor_mb((state, obs)), 1),
           "output_mb": round(tensor_mb(out), 1)}
    print(json.dumps(mem), flush=True)
    results.update(mem)

    if args.trace:
        held = [out[1]]

        def tick():
            held[0] = step(models, held[0], obs)[1]

        prof, durs = roofline.profile_device(tick, TRACE_TICKS, dev)
        classes = roofline.per_class_ms(durs, TRACE_TICKS)
        print("per-class ms/tick:", json.dumps(
            {k: round(v, 3) for k, v in classes.items()}))
        staged = (roofline.parse_trace_by_stage(prof) if dev.type == "cuda"
                  else {(name, ""): us for name, us in durs.items()})
        rows = [{"ms": round(us / TRACE_TICKS / 1000, 4), "name": name,
                 "class": roofline.classify_op(name), "stage": stage}
                for (name, stage), us in sorted(staged.items(),
                                                key=lambda kv: -kv[1])]
        print("top kernels (ms/tick):")
        for r in rows[:40]:
            print(f"  {r['ms']:8.3f}  {r['name'][:60]:62s} "
                  f"{r['class']:14s} {r['stage']}")
        if args.dump:
            with open(args.dump, "w") as f:
                json.dump(rows, f, indent=0)
            print(f"full table ({len(rows)} kernels) -> {args.dump}")
        results["classes_ms"] = classes
        results["hand_kernels"] = {
            name: round(us / TRACE_TICKS / 1000, 4)
            for name, us in durs.items()
            if roofline.hand_class(name) is not None}
    return results


if __name__ == "__main__":
    main()
