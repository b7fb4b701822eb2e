"""`remat` and lav_tpu's scoped student-crop checkpoint in the port's
distillation step (lav_tpu_torch.train.distill, models/planner.py), on
the CPU at tiny_config.

* `make_full_train_step(..., remat=True)` against the same step without
  it, from the same params, batch and draws, in f32 (B = 8) and in bf16
  (B = 8, crops of 64 as in tests/test_torch_train_bf16.py): the
  recompute runs the same operations on the same inputs, so the loss and
  every gradient leaf agree to 1e-6 relative (measured: equal), and the
  BN running statistics after `merge_bn_state` are equal.
* `utils/tree.py::checkpoint` keeps each BatchNorm's update of the
  forward: a module called on the other cars' input under the
  checkpoint, then on the ego's, holds the ego call's update after the
  backward pass, which recomputes the first call (plain
  `torch.utils.checkpoint` would leave the first call's); also when an
  outer checkpoint (remat) holds both calls.
* The scoped checkpoint at B = 32 in f32, where lav_tpu takes it too
  (`ckpt_crops`, lav_tpu `planner.py:398`), against lav_tpu's step:
  the port runs the student's crops and their embedding under
  `checkpoint` once a step (counted), its gradients and BN statistics
  equal the same step's without the checkpoint, and the crop ResNet's BN
  running statistics are the ego call's, as lav_tpu keeps them
  (`st_ego`), to tests/test_torch_train.py's 1e-5 (measured 2.5e-6).
  The step is ill-conditioned at this size, as that module's note says
  (3.6% in a leaf at B = 16): at B = 32 the loss terms are held to rtol
  1e-4 (measured 2.7e-5), grad_norm to 5e-3 (measured 2.1e-3), each
  gradient leaf to 8e-2 in L2 with a floor of 1e-6 grad_norm and all
  to 5e-2 (measured 3.6e-2 and 1.7e-2; with two other draws 1.7e-2 /
  7.9e-3 and 4.6e-2 / 2.4e-2).
"""

import jax
import pytest
import torch

from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.models import planner as TPL
from lav_tpu_torch.nn.layers import BatchNorm
from lav_tpu_torch.train import distill as TD
from lav_tpu_torch.utils.tree import bn_state, checkpoint, merge_bn_state
from tests import test_torch_train as T

REMAT_RTOL = 1e-6
B32_GRAD_TOL = (5e-3, 8e-2, 5e-2)   # grad_norm, each leaf, all leaves


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_matches_the_plain_step(dtype):
    dt = getattr(torch, dtype)
    crop = 16 if dt is torch.float32 else 64
    cfg = t_tiny_config(crop_size=crop)
    params, batch, _ = T._setup(8)
    noise = T._jax_noise(jax.random.key(5), 8)
    runs = []
    for remat in (False, True):
        models = T._port_models(params)
        step = TD.make_full_train_step(cfg, v2=True, compute_dtype=dt,
                                       remat=remat)
        metrics = step(models, TD.adam(models, T.LR), batch, noise=noise)
        runs.append((metrics, models))
    (m0, plain), (m1, remat) = runs
    for k, v in m0.items():
        assert abs(float(m1[k]) - float(v)) <= REMAT_RTOL * abs(float(v)), k
    grads = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        q = grads[name]
        if p.grad is None:
            assert q.grad is None, name
            continue
        err = float((q.grad - p.grad).norm())
        assert err <= REMAT_RTOL * float(p.grad.norm()), (name, err)
    bufs = dict(remat.named_buffers())
    for name, b in plain.named_buffers():
        assert torch.equal(bufs[name], b), name


class _TwoCalls(torch.nn.Module):
    """A BatchNorm called on the others' input, then on the ego's, as the
    student's crop ResNet is called."""

    def __init__(self):
        super().__init__()
        self.bn = BatchNorm(3, dim=-1).train()

    def forward(self, others, ego, scoped: bool):
        f = (lambda x: self.bn(x) * 2.0)
        a = (checkpoint(f, others, module=self, span="recompute")
             if scoped else f(others))
        return a.sum() + f(ego).sum()


@pytest.mark.parametrize("outer", [False, True])
def test_checkpoint_keeps_the_forward_bn_update(outer):
    g = torch.Generator().manual_seed(2)
    others = torch.randn((6, 3), generator=g).requires_grad_(True)
    ego = (torch.randn((4, 3), generator=g) * 3 + 1).requires_grad_(True)
    ref = _TwoCalls()
    ref(others, ego, scoped=False).backward()
    want = bn_state(ref)["bn"]
    m = _TwoCalls()
    if outer:   # remat: the whole forward under a checkpoint too
        loss = checkpoint(lambda o, e: m(o, e, scoped=True), others, ego,
                          module=m, span="recompute")
    else:
        loss = m(others, ego, scoped=True)
    loss.backward()
    got = bn_state(m)["bn"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the update differs from the others' call's, which a recompute that
    # kept its own would leave
    m.bn(others)
    assert not torch.equal(bn_state(m)["bn"][0], want[0])
    merge_bn_state(m)
    assert m.bn.new_stats is None


def test_scoped_checkpoint_at_b32_matches_lav_tpu(monkeypatch):
    B = 32
    params, batch, batch_j = T._setup(B)
    ref_step, opt = T._ref_step(True, "full", batch_j)
    rng = jax.random.key(7)
    ref_metrics, ref_grads, new_params, _ = ref_step(
        params, opt.init(params), rng)
    calls = []

    def counted(fn, *args, module, span):
        calls.append(module)
        return checkpoint(fn, *args, module=module, span=span)

    def step(scoped):
        monkeypatch.setattr(TPL, "checkpoint", counted if scoped else (
            lambda fn, *args, module, span: fn(*args)))
        models = T._port_models(params)
        metrics = TD.make_full_train_step(t_tiny_config(), v2=True)(
            models, TD.adam(models, T.LR), batch,
            noise=T._jax_noise(rng, B))
        return models, metrics

    bare, _ = step(False)
    models, metrics = step(True)
    assert calls == [models["uniplanner"].lidar_conv_emb]
    grads = dict(bare.named_parameters())
    for name, p in models.named_parameters():
        assert (p.grad is None and grads[name].grad is None) or torch.equal(
            p.grad, grads[name].grad), name
    bufs = dict(bare.named_buffers())
    for name, b in models.named_buffers():
        assert torch.equal(b, bufs[name]), name
    T._check_step("train.b32_scoped", models, metrics, ref_metrics,
                  ref_grads, B32_GRAD_TOL)
    T._check_update("train.b32_scoped", models, new_params, ref_grads, 1e-7,
                    {})
