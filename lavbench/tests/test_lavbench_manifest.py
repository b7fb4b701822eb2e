"""The manifest and the files it names: every configuration, cell and
per-layer metric is found by name, the manifest keeps to the contract's
shapes, and a new configuration, cell and metric are taken as files."""

import json
import re

import pytest

from lavbench import manifest
from lavbench.ref.config import LAVConfig
from lavbench.tests.helpers import LIDAR, REPO, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lavbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_a_configuration(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((REPO / entry["file"]).read_text())
    fields = {k: v for k, v in data.items()
              if k in LAVConfig.__dataclass_fields__}
    cfg = LAVConfig(**fields)
    assert cfg.num_frame_stack == 2 and cfg.max_lidar_points == 120000
    assert data["precision"]["tf32"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files_and_readers(cell):
    c = manifest.Cell(cell)
    assert c.traffic["loop"] in ("agent", "distill")
    assert c.loop().Loop is not None
    assert {m["name"] for m in c.end_to_end()} >= {"setup_s"}
    assert len(c.end_to_end()) >= 2 and c.per_layer()
    for m in c.per_layer():
        assert callable(c.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end()}
    assert set(c.limits["limits"])


def test_new_config_cell_and_metric_are_files(tiny):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files under a checkout, with BENCHMARK.json naming
    them, run with no other file changed."""
    cfg = json.loads((tiny / "lavbench/configs/tiny_f32.json").read_text())
    cfg["num_plan"] = 3
    (tiny / "lavbench/configs/tiny_other.json").write_text(json.dumps(cfg))
    (tiny / "lavbench/traffic/t_agent_one.json").write_text(json.dumps(dict(
        loop="agent", num_ego=1, points_per_sweep=128, img_hw=[64, 64],
        lidar=LIDAR,
        pool=2, warmup=1, check_egos=1, check_tick=[1, 2], trace_units=1)))
    limits = json.loads((tiny / "lavbench/limits/agent.f32.e16.json")
                        .read_text())
    (tiny / "lavbench/limits/agent.other.e1.json").write_text(
        json.dumps(limits))
    (tiny / "lavbench/metrics/ticks_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['summary']['units'])\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny_other", source="tiny",
                                 file="lavbench/configs/tiny_other.json",
                                 reduced=["num_plan"], why="tiny"))
    bench["workloads"].append(dict(name="agent.other.e1", config="tiny_other",
                                   traffic="t_agent_one", chips=1, why="x"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "agent.f32.e16" in m["workloads"]:
            m["workloads"].append("agent.other.e1")
    bench["per_layer"].append(dict(
        name="ticks_traced", unit="ticks", better="higher",
        source="device_trace", layer="agent tick", moves="ego_ticks_per_s",
        workloads=["agent.other.e1"]))
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line = run_cell(tiny, "agent.other.e1", trace=1, seconds=0.5)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["ticks_traced"]["value"] == 1.0
    rc, line = run_cell(tiny, "agent.other.e1", seconds=0.5)
    assert rc == 0
    assert set(line["metrics"]) == {"ego_ticks_per_s", "tick_ms_p95",
                                    "setup_s"}


def test_missing_cell_exits_without_result(tiny):
    rc, line = run_cell(tiny, "no.such.cell")
    assert rc == 2 and line is None
