"""The port's distillation step (lav_tpu_torch.train.distill) against
lav_tpu's on the CPU, at tiny_config with 64 points an item: B = 8 for v2
"full", B = 16 for the v1 modes.

lav_tpu's step is `make_full_train_step`'s body, jitted: value_and_grad
of `make_distill_forward`, `optax.global_norm`, `optax.adam(3e-4)` and
`merge_bn_state`; it also returns the gradients.  The params come from
the port's initialisers (seed 0), turned into lav_tpu's tree
(`torch_parity.jax_tree`), and the port's models load that tree
(`utils/weights.py`) again; the batch is the one both sides
use (`make_batch`, numpy seed 0), and its forward takes lav_tpu's draws:
the uniforms `uniplanner_forward` draws from its key, split as it splits
it (`_jax_noise`).  The v2 "full" step is compared after one step and
after a second, for which the port first loads lav_tpu's params of after
step 1 (its Adam moments stay its own); v1 "perceive_only" and
"motion_only" after one step (tests/test_torch_train_modes.py).

Tolerances, f32, each above what was measured with a margin.  The step
is ill-conditioned at this size, and erratically so: train-mode
BatchNorm over a few 1x1 crops at the crop ResNet's layer4, and ReLUs
before the lidar model's BatchNorms, amplify rounding.  Scaling the
input points by 1 + 1e-6 (which may also move a point across a pillar's
edge) moves the port's v1 "motion_only" gradients by 0.9% in all (1.9%
in a leaf) at B = 8 but 6e-5 at B = 16; v2 "full" agrees with lav_tpu
to 0.5% in its worst leaf at B = 8, and 3.6% at B = 16.  So each configuration runs where it is well conditioned:
  * the loss terms to rtol 1e-4 (measured <= 1.6e-5);
  * v2 "full" (B = 8): grad_norm to rtol 1e-3 (measured 2.5e-5), each
    gradient leaf in L2, |g_port - g_jax| <= 2e-2 |g_jax| + 1e-6
    grad_norm (measured <= 0.5%; the floor covers the biases before a
    BatchNorm, whose exact gradient is 0 and whose f32 values are noise,
    ~1e-8), and all leaves together to 2e-3 of grad_norm (measured
    <= 2.9e-4);
  * v1 "perceive_only" and "motion_only" (B = 16): grad_norm to rtol
    2e-3 (measured 1.4e-4 / 3.0e-4), each leaf to 3e-2 (measured 0.4% /
    0.7%) and all leaves to 1.5e-2 (measured 2.1e-3 / 3.3e-3);
  * the updated params: Adam's first step is lr * g / (|g| + eps), about
    lr * sign(g), and a sign is noise where |g| is, so the update is held
    to 1e-7 + 1e-6 |p| after step 1 and 1e-2 lr + 1e-6 |p| after step 2
    only where |g_jax| >= 1e-4 (far above eps = 1e-8) and the port's
    gradient is within 1e-3 of it, in this step and the one before
    (7-13% of the elements for v2; measured 1.2e-7 and 2.9e-7);
    elsewhere a sign may flip, and the update only has to stay within
    Adam's bound, 2 lr;
  * the BN running statistics (lav_tpu's ego-wins rule for the student's
    crop ResNet included) to atol 1e-5 + rtol 1e-5 (measured <= 4.3e-6
    on values up to ~1): they come from the forward.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from lav_tpu.config import tiny_config
from lav_tpu.train.distill import make_distill_forward
from lav_tpu.utils.tree import merge_bn_state as j_merge_bn_state
from lav_tpu_torch.config import tiny_config as t_tiny_config
from lav_tpu_torch.train import distill as TD
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import check_grads, check_update, jax_tree

CFG = tiny_config()
TCFG = t_tiny_config()
P, LR = 64, 3e-4
B_V2 = 8     # items of the v2 test; tests/test_torch_train_modes.py: 16
METRIC_RTOL, FLOOR, STAT_TOL = 1e-4, 1e-6, 1e-5
SURE_G, SURE_REL, STEP2_UPD_TOL = 1e-4, 1e-3, 1e-2 * LR
# (grad_norm rtol, each leaf's L2, all leaves' L2): see the module note
V2_GRAD_TOL = (1e-3, 2e-2, 2e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _setup(B):
    """lav_tpu params (from the port's initialisers: lav_tpu's own take
    about 20 s to compile here), and the batch of B items for both
    sides."""
    tree = jax_tree(TD.distill_models(TCFG, torch.Generator().manual_seed(0)))
    params = jax.tree.map(jnp.asarray, tree)
    batch = TD.make_batch(TCFG, B, P, seed=0, device="cpu")
    return params, batch, {k: jnp.asarray(v.numpy()) for k, v in
                           batch.items()}


def _jax_noise(rng, B):
    """The uniforms lav_tpu's uniplanner_forward draws from `rng` for B
    items."""
    N, K = CFG.max_objs - 1, CFG.max_num_cars_student
    r_sel, r_o, r_e = jax.random.split(rng, 3)
    kl, ko = jax.random.split(r_o)
    el, eo = jax.random.split(r_e)
    u = jax.random.uniform
    d = dict(scores=u(r_sel, (B, N)), loc_o=u(kl, (B, K, 2)),
             ori_o=u(ko, (B, K)), loc_e=u(el, (B, 2)), ori_e=u(eo, (B,)))
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _ref_step(v2, mode, batch_j):
    """lav_tpu's make_full_train_step body, jitted, with the gradients."""
    fwd = make_distill_forward(CFG, v2=v2, mode=mode)
    opt = optax.adam(LR)

    @jax.jit
    def step(params, opt_state, rng):
        (_, (state, metrics)), grads = jax.value_and_grad(
            lambda p: fwd(p, batch_j, rng), has_aux=True)(params)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = j_merge_bn_state(optax.apply_updates(params, updates),
                                  state)
        return metrics, grads, params, opt_state

    return step, opt


_SCRATCH = []


def _port_models(params):
    """The port's models holding lav_tpu's `params`."""
    return load_jax_params(TD.distill_models(TCFG), _tree(params))


def _as_port(tree):
    """A port model holding lav_tpu's `tree` (params or grads) for a
    check to read; the two calls of a check take turns on two models
    built once."""
    if len(_SCRATCH) < 2:
        _SCRATCH.append(TD.distill_models(TCFG))
    else:
        _SCRATCH.append(_SCRATCH.pop(0))
    return load_jax_params(_SCRATCH[-1], _tree(tree))


def _check_step(tag, models, metrics, ref_metrics, ref_grads, grad_tol):
    gnorm_rtol, leaf_l2, all_l2 = grad_tol
    check_grads(tag, models, metrics, ref_metrics, _as_port(ref_grads),
                dict(metric=METRIC_RTOL, grad_norm=gnorm_rtol, leaf=leaf_l2,
                     all=all_l2, floor=FLOOR))


def _check_update(tag, models, ref_params, ref_grads, upd_tol, close):
    """Updated params and BN running statistics against lav_tpu's: to
    `upd_tol` where the two gradients of this and every earlier step
    agree (`close`, name -> mask, updated here), to Adam's bound
    elsewhere (see the module note)."""
    check_update(tag, models, _as_port(ref_params), _as_port(ref_grads),
                 upd_tol, close, LR, STAT_TOL, SURE_G, SURE_REL)


def test_v2_full_one_and_two_steps_match_lav_tpu():
    params, batch, batch_j = _setup(B_V2)
    ref_step, opt = _ref_step(True, "full", batch_j)
    models = _port_models(params)
    optimizer = TD.adam(models, LR)
    step = TD.make_full_train_step(TCFG, v2=True, mode="full")
    opt_state = opt.init(params)
    close = {}
    for it, upd_tol in ((1, 1e-7), (2, STEP2_UPD_TOL)):
        rng = jax.random.key(it)
        ref_metrics, ref_grads, params, opt_state = ref_step(
            params, opt_state, rng)
        metrics = step(models, optimizer, batch,
                       noise=_jax_noise(rng, B_V2))
        _check_step(f"train.v2_step{it}", models, metrics, ref_metrics,
                    ref_grads, V2_GRAD_TOL)
        _check_update(f"train.v2_step{it}", models, params, ref_grads,
                      upd_tol, close)
        # step 2 starts from lav_tpu's params (see the module note)
        load_jax_params(models, _tree(params))


def test_teacher_and_other_bank_stay_frozen():
    """The teacher and the `other` cast bank take no gradient and keep
    their values; the teacher stays in eval mode."""
    params, batch, _ = _setup(2)
    models = _port_models(params)
    before = {n: p.detach().clone() for n, p in models.named_parameters()}
    step = TD.make_full_train_step(TCFG, v2=True)
    step(models, TD.adam(models, LR), batch,
         gen=torch.Generator().manual_seed(0))
    uni = models["uniplanner"]
    assert not uni.bev_planner.training and uni.lidar_conv_emb.training
    for name, p in models.named_parameters():
        frozen = name.startswith(("uniplanner.bev_planner.",
                                  "uniplanner.cast_grus_other.",
                                  "uniplanner.cast_mlps_other."))
        assert (p.grad is None) == frozen, name
        assert torch.equal(p.detach(), before[name]) == frozen, name
