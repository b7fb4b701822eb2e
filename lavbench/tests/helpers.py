"""Helpers of the benchmark's CPU tests."""

import dataclasses
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
INT8 = "agent.int8.e16"
# the agent cells' sensor (lavbench/traffic/agent_e16_p10k.json)
LIDAR = json.loads((REPO / "lavbench/traffic/agent_e16_p10k.json")
                   .read_text())["lidar"]


def tiny_root(path: Path, *, num_ego: int = 2, points: int = 256) -> Path:
    """A checkout root at `path`: the real metrics and limits, tiny
    configurations (`tiny_config` with the v2 frame stack) and traffic."""
    from lavbench.ref.config import tiny_config

    root = Path(path)
    (root / "lavbench").mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "limits"):
        shutil.copytree(REPO / "lavbench" / d, root / "lavbench" / d,
                        dirs_exist_ok=True)
    for d in ("traffic", "configs"):
        (root / "lavbench" / d).mkdir(exist_ok=True)
    cfg = tiny_config(num_frame_stack=2, num_features=[16, 16])
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, quant, dtype, pallas in (
            ("tiny_int8", "mxu", "bfloat16", False),
            ("tiny_f32", None, "float32", True)):
        (root / f"lavbench/configs/{name}.json").write_text(json.dumps(dict(
            fields, precision={"compute_dtype": dtype, "int8": quant,
                               "tf32": False},
            program={"use_pallas": pallas})))
    (root / "lavbench/traffic/t_agent.json").write_text(json.dumps(dict(
        loop="agent", num_ego=num_ego, points_per_sweep=points,
        img_hw=[64, 64], lidar=LIDAR, pool=3, warmup=2, check_egos=2, check_tick=[2, 4],
        trace_units=2)))
    (root / "lavbench/traffic/t_distill.json").write_text(json.dumps(dict(
        loop="distill", batch_size=4, points=points, pool=4, lr=3e-4,
        remat=True, trace_units=2)))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        dict(name=n, source="tiny", file=f"lavbench/configs/{n}.json",
             reduced=[], why="tiny") for n in ("tiny_int8", "tiny_f32")]
    for w in bench["workloads"]:
        w["config"] = "tiny_int8" if ".int8." in w["name"] else "tiny_f32"
        w["traffic"] = ("t_distill" if w["name"].startswith("distill")
                        else "t_agent")
    # the int8 production tick: its limits and traffic are files of the
    # benchmark, though its cell is not in BENCHMARK.json (PERF.md, section
    # 7); its check runs here at tiny size, reporting the agent metrics
    if INT8 not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(dict(name=INT8, config="tiny_int8",
                                       traffic="t_agent", chips=1, why="tiny"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "agent.f32.e16" in m.get("workloads", ()):
                m["workloads"].append(INT8)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root, cell, *, seed=3000000001, seconds=1.0, trace=0,
             control=False):
    """One run of `cell` in `root` on the CPU -> (exit code, result)."""
    import io

    from lavbench import run

    buf = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device="cpu", control=control, out=buf)
    text = buf.getvalue().strip()
    return rc, (json.loads(text.splitlines()[-1]) if text else None)
