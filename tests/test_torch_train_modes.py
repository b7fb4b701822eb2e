"""The port's v1 distillation step in modes "perceive_only" (det + seg;
here) and "motion_only" (the motion losses alone;
tests/test_torch_train_motion.py, a file of its own so that the two
compiles of lav_tpu's step run on two workers) against lav_tpu's, one
step each on the CPU at tiny_config, B = 16: loss terms, every gradient leaf,
the updated params and the BN running statistics.  Setup, draws and
tolerances are tests/test_torch_train.py's (its module note).  A mode's
loss leaves part of the models without a gradient: lav_tpu gives those
leaves zeros and Adam moves them by 0, the port leaves their `.grad`
None and Adam skips them, so both keep their values.
"""

import jax
import pytest
import torch

from lav_tpu_torch.train import distill as TD
from tests import test_torch_train as T

# (grad_norm rtol, each leaf's L2, all leaves' L2), with the reason in
# tests/test_torch_train.py's module note
V1_GRAD_TOL = (2e-3, 3e-2, 1.5e-2)
B = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def check_v1_mode(mode):
    """One v1 step of `mode`, port against lav_tpu."""
    params, batch, batch_j = T._setup(B)
    ref_step, opt = T._ref_step(False, mode, batch_j)
    models = T._port_models(params)
    optimizer = TD.adam(models, T.LR)
    rng = jax.random.key(3)
    ref_metrics, ref_grads, new_params, _ = ref_step(
        params, opt.init(params), rng)
    metrics = TD.make_full_train_step(T.TCFG, v2=False, mode=mode)(
        models, optimizer, batch, noise=T._jax_noise(rng, B))
    tag = f"train.v1_{mode}"
    T._check_step(tag, models, metrics, ref_metrics, ref_grads,
                  V1_GRAD_TOL)
    T._check_update(tag, models, new_params, ref_grads, 1e-7, {})
    untouched = ("uniplanner." if mode == "perceive_only" else
                 ("lidar_model.center_head.", "lidar_model.box_head.",
                  "lidar_model.ori_head.", "lidar_model.seg_head."))
    for name, p in models.named_parameters():
        if name.startswith(untouched):
            assert p.grad is None, name


def test_v1_perceive_only_matches_lav_tpu():
    check_v1_mode("perceive_only")
