"""The port's checkpoints (lav_tpu_torch.train.checkpoints), its LAV
state_dict converters (utils/weights.py) and the brake net's ImageNet init
against lav_tpu's on the CPU, at tiny_config.

  * A snapshot (params with BN statistics, Adam's moments, the StepLR
    count, a partial gradient mean of --grad-accum, epoch and it) saved and
    loaded into fresh objects equals the original exactly, and both go on
    to the same params bit for bit.
  * `load_params` takes a snapshot or a bare state_dict.
  * Every `convert_*` gives lav_tpu's tree, array for array
    (`np.array_equal`), on one made-up state_dict; `convert_*` of
    `export_*` (lav_tpu's) of a module's params loads into the port's
    module equal to `load_jax_params` of the same params, also through a
    `.th` file and `load_torch_state_dict`.
  * `BrakeModel(imagenet_sd=...)`'s backbone equals lav_tpu's
    `brake_model_init(imagenet_sd=...)` exactly, for a resnet18
    state_dict in torchvision's layout that the test builds.
"""

import argparse
import zlib

import jax
import numpy as np
import pytest
import torch

from lav_tpu.models.rgb import brake_model_init
from lav_tpu.utils import weights as JW
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.models.planner import BEVPlanner, UniPlanner
from lav_tpu_torch.models.rgb import BrakeModel
from lav_tpu_torch.nn.resnet import resnet18
from lav_tpu_torch.train import checkpoints as CK
from lav_tpu_torch.train import cli
from lav_tpu_torch.train.distill import MultiSteps, adam
from lav_tpu_torch.train.privileged import step_lr
from lav_tpu_torch.utils import weights as TW
from tests.torch_parity import jax_tree

TCFG = tiny_config()


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _seeded(seed):
    return torch.Generator().manual_seed(seed)


def _objects(seed, k=2):
    models = BEVPlanner(TCFG, _seeded(seed))
    opt = adam(models, 3e-4)
    return models, MultiSteps(opt, k, step_lr(opt, 3e-4, 2, 1))


def _micro_step(models, opt, i):
    """A made-up micro-step: gradients and BN statistics from seed i."""
    g = _seeded(100 + i)
    opt.zero_grad()
    for p in models.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    with torch.no_grad():
        for name, b in models.named_buffers():
            if name.endswith(".mean"):
                b.add_(torch.randn(b.shape, generator=g))
    opt.step()


def _states_equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_states_equal, a, b))
    return a == b


def test_snapshot_round_trip_is_exact(tmp_path):
    models, opt = _objects(0)
    for i in range(5):      # two updates and half of a third
        _micro_step(models, opt, i)
    assert opt.mini_step == 1 and opt.acc
    assert opt.scheduler.last_epoch == 2
    path = CK.save_checkpoint(str(tmp_path / "bev_3"),
                              CK.snapshot(models, opt, 3, 5))
    models2, opt2 = _objects(1)
    snap = CK.load_checkpoint(path, models2, opt2)
    assert (snap["epoch"], snap["it"]) == (3, 5)
    assert _states_equal(models.state_dict(), models2.state_dict())
    assert _states_equal(opt.state_dict(), opt2.state_dict())
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    for i in range(5, 8):
        _micro_step(models, opt, i)
        _micro_step(models2, opt2, i)
    assert _states_equal(models.state_dict(), models2.state_dict())
    assert _states_equal(opt.state_dict(), opt2.state_dict())


def test_load_params_takes_a_snapshot_or_bare_params(tmp_path):
    models, opt = _objects(0)
    _micro_step(models, opt, 0)
    _micro_step(models, opt, 1)
    snap = CK.save_checkpoint(str(tmp_path / "snap"),
                              CK.snapshot(models, opt, 1, 2))
    bare = CK.save_checkpoint(str(tmp_path / "bare"), models.state_dict())
    for path in (snap, bare):
        got = CK.load_params(path, BEVPlanner(TCFG, _seeded(3)))
        assert _states_equal(got.state_dict(), models.state_dict())
    # the teacher inside the UniPlanner takes the BEV planner's params
    uni = UniPlanner(TCFG, _seeded(4), teacher=True)
    CK.load_params(snap, uni.bev_planner)
    assert _states_equal(uni.bev_planner.state_dict(), models.state_dict())


class _MadeUp(dict):
    """A state_dict that makes up every array a converter asks for, the
    same for the same key (4-D weights, so that every layout change
    applies), and claims every optional key."""

    def __missing__(self, key):
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        shape = (2, 3, 4, 5) if "weight" in key else (5,)
        self[key] = rng.normal(size=shape).astype(np.float32)
        return self[key]

    def __contains__(self, key):
        return True


def _trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


CONVERTERS = {
    "resnet": dict(prefix="conv_backbone."),
    "erfnet": dict(prefix="erfnet."),
    "seg_model": {},
    "brake_model_v1": dict(version=1),
    "brake_model_v2": dict(version=2),
    "lidar_model": dict(num_features=(8, 8)),
    "bev_planner": dict(num_cmds=6),
    "uniplanner": dict(num_cmds=6),
}


@pytest.mark.parametrize("name", CONVERTERS)
def test_converters_give_lav_tpus_tree(name):
    fn = "convert_" + name.replace("_v1", "").replace("_v2", "")
    want = getattr(JW, fn)(_MadeUp(), **CONVERTERS[name])
    got = getattr(TW, fn)(_MadeUp(), **CONVERTERS[name])
    _trees_equal(want, got)


def _round_trip(module, export, convert, tmp_path):
    """export (lav_tpu's) of the module's params, then through a .th file,
    the port's convert and load_jax_params into a fresh module."""
    sd = export(jax_tree(module))
    path = str(tmp_path / "lav.th")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    loaded = TW.load_torch_state_dict(path)
    assert sorted(loaded) == sorted(sd)
    for k in sd:
        assert np.array_equal(loaded[k], sd[k]), k
    return convert(loaded)


@pytest.mark.parametrize("kind", ["bev_planner", "uniplanner"])
def test_export_then_convert_loads_into_the_port(kind, tmp_path):
    if kind == "bev_planner":
        make = lambda seed: BEVPlanner(TCFG, _seeded(seed))  # noqa: E731
        export, convert = JW.export_bev_planner, TW.convert_bev_planner
    else:
        make = lambda seed: UniPlanner(  # noqa: E731
            TCFG, _seeded(seed), teacher=True)
        export, convert = JW.export_uniplanner, TW.convert_uniplanner
    module = make(0)
    tree = _round_trip(module, export, convert, tmp_path)
    want = TW.load_jax_params(make(1), jax_tree(module))
    got = TW.load_jax_params(make(2), tree)
    assert _states_equal(got.state_dict(), want.state_dict())
    assert _states_equal(got.state_dict(), module.state_dict())


def _imagenet_sd():
    """A resnet18 state_dict in torchvision's layout, fc included."""
    sd = JW.export_resnet({}, "", jax_tree(resnet18(3, gen=_seeded(5))))
    rng = np.random.default_rng(0)
    sd["fc.weight"] = rng.normal(size=(1000, 512)).astype(np.float32)
    sd["fc.bias"] = rng.normal(size=(1000,)).astype(np.float32)
    return sd


def test_brake_imagenet_init_matches_lav_tpu(tmp_path):
    sd = _imagenet_sd()
    want = brake_model_init(jax.random.key(0), 3, version=2,
                            imagenet_sd=sd)["conv_backbone"]
    model = BrakeModel(2, _seeded(0), imagenet_sd=sd)
    _trees_equal(jax.tree.map(np.asarray, want),
                 jax_tree(model.conv_backbone))
    # the CLI's --imagenet-weights reads the same from a .pth
    path = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    args = argparse.Namespace(imagenet_weights=path)
    got = BrakeModel(2, _seeded(1),
                     imagenet_sd=cli._imagenet_sd(TCFG, args))
    assert _states_equal(got.conv_backbone.state_dict(),
                         model.conv_backbone.state_dict())
    args.imagenet_weights = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        cli._imagenet_sd(TCFG, args)
