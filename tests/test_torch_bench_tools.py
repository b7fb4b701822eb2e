"""The port's measurement tools (`lav_tpu_torch/utils/bench_*.py`) on the
CPU.

* bench_chain's five stage functions (stack -> pillar -> lidar -> decode
  -> plan) against lav_tpu's public functions composed as
  `lav_tpu/utils/bench_chain.py` composes them, at tiny_config with
  num_frame_stack=2, f32, the weights lav_tpu's initialisers draw
  (converted by `utils/weights.py`) and the port's seeded ring buffers:
  atol 1e-4 / rtol 1e-3, the agent tests' tolerance for f32 (lav_tpu's
  canvas carries zero lanes up to 128, a TPU layout the port leaves
  out: they are held to zero);
* every tool's `main` at a tiny size with `--device cpu` prints the keys
  lav_tpu's prints for the same flags (`lav_tpu/utils/bench_skip.py:79-
  90`, `bench_ablate.py:141`, `bench_chain.py:119`, `bench_profile.py:
  54-67`, `bench_train.py:163-168`), after a line naming the device;
* without a card each tool raises rather than running on the CPU.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lav_tpu.config import tiny_config
from lav_tpu.core.geometry import move_lidar_points
from lav_tpu.models.lidar import lidar_model_apply, lidar_model_init
from lav_tpu.models.planner import uniplanner_infer, uniplanner_init
from lav_tpu.ops.peak import det_inference
from lav_tpu.ops.pillar import point_pillar_apply
from lav_tpu_torch.agent import setup as S
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.train import privileged as PV
from lav_tpu_torch.utils import (
    bench_ablate, bench_chain, bench_profile, bench_skip, bench_train,
)
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close

ATOL, RTOL = 1e-4, 1e-3
B, POINTS = 2, 64
HW = (32, 32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cfgs():
    return tiny_config(num_frame_stack=2), t_tiny_config(num_frame_stack=2)


def _jax_chain(params, cfg, inp):
    """lav_tpu/utils/bench_chain.py's five stages, in f32."""
    buf, val, locs, oris, cmd, nxp = (jnp.asarray(inp[k].numpy()) for k in
                                      ("buf", "val", "locs", "oris", "cmd",
                                       "nxp"))
    num_stack = cfg.num_frame_stack + 1
    num_keep, Pb = buf.shape[1], buf.shape[2]
    lk = dict(min_x=cfg.min_x, max_x=cfg.max_x, min_y=cfg.min_y,
              max_y=cfg.max_y, pixels_per_meter=cfg.pixels_per_meter,
              num_features=cfg.num_features)

    def stack_one(buf, val, locs, oris):
        loc0, ori0 = locs[-1], oris[-1]
        sweeps, valids = [], []
        for i in range(num_stack):
            idx = num_keep - 1 - i * 5
            sweep = buf[idx]
            xyz = move_lidar_points(sweep[:, :3], locs[idx] - loc0, ori0,
                                    oris[idx])
            age = jnp.zeros((Pb, num_stack)).at[:, i].set(1.0)
            sweeps.append(jnp.concatenate([xyz, sweep[:, 3:], age], -1))
            valids.append(val[idx])
        return jnp.concatenate(sweeps, 0), jnp.concatenate(valids, 0)

    stacked, svalid = jax.vmap(stack_one)(buf, val, locs, oris)
    canvas, _ = point_pillar_apply(params["lidar_model"]["point_pillar"],
                                   stacked, svalid, train=False, **lk)
    lidar = lidar_model_apply(params["lidar_model"], stacked, svalid,
                              train=False, **lk)[:5]
    feats, hm, size, ori, _ = lidar
    H, W = cfg.ny, cfg.nx
    ego_px = jnp.array([W / 2, H / 2 + cfg.y_offset * H / 2])
    dets = jax.vmap(lambda h, s, o: det_inference(
        jax.nn.sigmoid(h), s, o, pixels_per_meter=cfg.pixels_per_meter,
        max_det=cfg.max_det, min_score=cfg.det_min_score,
        ego_xy=ego_px))(hm, size, ori)
    veh = {k: v[:, 1] for k, v in dets._asdict().items()}
    plan = jax.vmap(lambda f, d, c, n: uniplanner_infer(
        params["uniplanner"], cfg, f, d, c, n)[0])(feats, veh, cmd, nxp)
    return dict(stack=(stacked, svalid), pillar=canvas, lidar=lidar,
                decode=(feats, dets._asdict()), plan=plan)


@pytest.fixture(scope="module")
def chain():
    torch.set_num_threads(1)
    jcfg, tcfg = _cfgs()
    k1, k2 = jax.random.split(jax.random.key(3))
    params = {"lidar_model": lidar_model_init(k1, jcfg.num_input,
                                              jcfg.num_features),
              "uniplanner": uniplanner_init(k2, jcfg)}
    models = load_jax_params(bench_chain.chain_models(tcfg),
                             jax.tree.map(np.asarray, params)).eval()
    inp = bench_chain.chain_inputs(tcfg, B, POINTS, device="cpu")
    return models, tcfg, inp, _jax_chain(params, jcfg, inp)


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    return [x]


@pytest.mark.parametrize("stage", [n for n, _ in bench_chain.STAGES])
def test_chain_stage_equals_lav_tpu(chain, stage):
    models, cfg, inp, want = chain
    fn = dict(bench_chain.STAGES)[stage]
    with torch.no_grad():
        got = fn(models, cfg, inp, torch.float32)
    if stage == "decode":
        got = (got[0], got[1]._asdict())
    got, want = _leaves(got), _leaves(want[stage])
    if stage == "pillar":   # lav_tpu pads its canvas to 128 lanes
        C = got[0].shape[-1]
        assert not np.asarray(want[0])[..., C:].any()
        want = [np.asarray(want[0])[..., :C]]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (stage, i)
        assert_close(f"{stage}[{i}]", g.float().numpy(),
                     w.astype(np.float32), ATOL, RTOL)


@pytest.fixture
def tiny(monkeypatch):
    """Every tool at tiny_config (v2-like, num_frame_stack=2), 32x32
    images, one iteration."""
    cfg = functools.partial(t_tiny_config, num_frame_stack=2)
    for mod in (bench_skip, bench_ablate, bench_chain, S):
        monkeypatch.setattr(mod, "v2_config", cfg)
    monkeypatch.setattr(bench_train, "v2_config", cfg)
    monkeypatch.setattr(bench_train, "v1_config", cfg)
    for mod in (bench_skip, bench_ablate):
        monkeypatch.setattr(mod, "IMG_HW", HW)
        monkeypatch.setattr(mod, "TEL_HW", HW)
    monkeypatch.setattr(bench_profile, "IMG_HW", HW)
    monkeypatch.setattr(S, "TEL_HW", HW)
    monkeypatch.setattr(bench_train, "ITERS", 1)
    monkeypatch.setattr(bench_train, "WARMUP", 1)
    monkeypatch.setattr(PV, "seg_batch",
                        functools.partial(PV.seg_batch, hw=HW))
    monkeypatch.setattr(PV, "bra_batch", functools.partial(
        PV.bra_batch, hws=((HW[0], 3 * HW[1]), HW)))
    monkeypatch.setattr(bench_chain, "NUM_EGO", B)
    monkeypatch.setattr(bench_chain, "SWEEP_POINTS", POINTS)


def _lines(out):
    lines = out.strip().splitlines()
    assert lines[0] == "device: cpu"
    return [json.loads(ln) for ln in lines if ln.startswith("{")]


SIZE = ["--device", "cpu", "--num-ego", str(B), "--max-points",
        str(POINTS), "--iters", "1"]


def test_bench_skip_main(tiny, capsys):
    res = bench_skip.main(SIZE)
    lines = _lines(capsys.readouterr().out)
    names = bench_skip.VARIANTS.split(",")
    assert [set(x) for x in lines[:-1]] == [{f"skip_{v}_ms"} for v in names]
    assert set(lines[-1]) == {"full_ms", "attributed_ms"}
    assert set(lines[-1]["attributed_ms"]) == set(names) - {"none"}
    assert lines[-1]["full_ms"] == res["skip_none_ms"] > 0


def test_bench_ablate_main(tiny, capsys):
    bench_ablate.main(SIZE + ["--dtype", "f32"])
    (line,) = _lines(capsys.readouterr().out)
    assert set(line) == {"seg_ms", "brake_ms", "paint_ms", "pillar_ms",
                         "lidar_model_ms", "det_decode_ms", "planner_ms",
                         "num_ego", "dtype"}
    assert line["num_ego"] == B and line["dtype"] == "f32"
    assert all(v > 0 for k, v in line.items() if k.endswith("_ms"))


def test_bench_chain_main(tiny, capsys):
    bench_chain.main(["--device", "cpu", "--iters", "1"])
    lines = _lines(capsys.readouterr().out)
    names = ["stack", "pillar", "lidar", "decode", "plan"]
    assert [set(x) for x in lines[:-1]] == [{f"thru_{n}_ms"} for n in names]
    assert set(lines[-1]) == {f"thru_{n}_ms" for n in names}


@pytest.mark.parametrize("quant", [None, "mxu"])
def test_bench_profile_main(tiny, capsys, tmp_path, quant):
    dump = tmp_path / "table.json"
    argv = SIZE[:-2] + ["--trace", "--dump", str(dump)]
    res = bench_profile.main(argv + (["--quant", quant] if quant else []))
    out = capsys.readouterr().out
    lines = _lines(out)
    assert set(lines[0]) == {"num_ego", "gflops_per_tick",
                             "gbytes_per_tick", "gflops_per_ego_step"}
    assert set(lines[1]) == {"temp_mb", "argument_mb", "output_mb"}
    assert lines[0]["gbytes_per_tick"] is None and \
        lines[1]["temp_mb"] is None
    assert lines[0]["gflops_per_tick"] > 0 and lines[1]["argument_mb"] > 0
    assert ("quant: mxu" in out) == bool(quant)
    assert "per-class ms/tick:" in out and res["classes_ms"]
    rows = json.loads(dump.read_text())
    assert rows and set(rows[0]) == {"ms", "name", "class", "stage"}


@pytest.mark.parametrize("argv", [
    ["--stage", "bev", "--v2"], ["--stage", "bev"], ["--stage", "seg"],
    ["--stage", "bra", "--v2"], ["--stage", "full", "--v2"],
    ["--stage", "full", "--remat"]], ids=lambda a: "_".join(a).lstrip("-"))
def test_bench_train_main(tiny, capsys, argv):
    bench_train.main(argv + ["--device", "cpu", "--batch-size", "2",
                             "--max-points", str(POINTS)])
    (line,) = _lines(capsys.readouterr().out)
    assert set(line) == {"stage", "v2", "batch_size", "dtype", "step_ms",
                         "samples_per_sec"}
    assert line["stage"] == argv[1] and line["v2"] == ("--v2" in argv)
    assert line["batch_size"] == 2 and line["step_ms"] > 0


@pytest.mark.parametrize("tool", [bench_skip, bench_ablate, bench_chain,
                                  bench_profile, bench_train],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_run_on_the_card_by_default(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
