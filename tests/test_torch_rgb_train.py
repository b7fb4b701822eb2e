"""The port's camera trainers (lav_tpu_torch.train.privileged: the seg
step, the brake step v1 and v2) and train-mode camera nets against
lav_tpu's on the CPU, at small images: seg 32x32 with 5 classes (4 seg
channels), brake wide 64x192 and telephoto 64x128 with 4 classes, B = 4.

lav_tpu's steps are `make_seg_train_step`'s and `make_bra_train_step`'s
bodies, jitted, returning the gradients too, as in
tests/test_torch_privileged.py; the params come from the port's
initialisers (seed 0) through `torch_parity.jax_tree`.  The seg step
takes lav_tpu's dropout masks: lav_tpu splits its key into one key per
non-bottleneck block, decoder blocks included though their rate is 0
(lav_tpu/nn/erfnet.py:111-115), and draws each mask with
jax.random.bernoulli on the block's NHWC output; `_jax_masks` rebuilds
them so and hands them to the port transposed to NCHW.

Tolerances, f32, each above what was measured here (in brackets).  Both
steps are ill-conditioned at these sizes, as the distillation step is
(tests/test_torch_train.py): scaling the input images by 1 + 1e-6 moves
the port's own gradients, all leaves together, by 5% (seg, B = 4; 2.5% at
B = 8, 2.1% at 64x64) and 0.24% (brake v1; 0.19% at B = 8); ERFNet's
train-mode forward alone, with no dropout, agrees with lav_tpu to 4e-7
block by block but to 1.2e-4 of its largest logit through all of them.
So the gradients are held per step, to what the two packages' rounding
can reach, and the loss and the BN statistics, which come from the
forward, tightly:
  * the loss to rtol 1e-4 [<= 1.4e-7];
  * seg: grad_norm to rtol 1e-2 [1.1e-3], each gradient leaf in L2 to
    1e-1 of its norm + 1e-6 grad_norm [1.8%], all leaves to 5e-2 of
    grad_norm [1.2%] (at B = 8, 16 or 64x64: up to 1.4e-3, 4.5%, 3.5%);
  * brake v1 / v2: grad_norm to rtol 1e-3 [3.0e-5 / 5.5e-6], each leaf to
    5e-2 [1.5% / 1.2%], all leaves to 2e-2 [0.43% / 0.37%];
  * the updated params as tests/test_torch_train.py holds them
    (`torch_parity.check_update`, 1e-7 where the gradients agree) and
    the BN running statistics (for the brake net the telephoto call's
    update: backbone and head) to atol = rtol = 1e-5;
  * ERFNet in train mode with lav_tpu's masks: logits to atol 5e-3 on
    values up to ~4.4 [6.2e-4], its BN statistics to 1e-5;
  * the brake net with its head in eval mode to atol 1e-4 [1.1e-8].
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lav_tpu.models import losses as J_losses
from lav_tpu.models.rgb import (
    brake_model_apply, brake_model_init, seg_model_apply, seg_model_init,
)
from lav_tpu.nn.erfnet import erfnet_apply
from lav_tpu.utils.tree import merge_bn_state as j_merge_bn_state
from lav_tpu_torch.config import v1_config
from lav_tpu_torch.models.rgb import BRAKE_SEG_CHANNELS, BrakeModel, SegModel
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.erfnet import NonBottleneck1d
from lav_tpu_torch.nn.resnet import resnet_apply
from lav_tpu_torch.train import privileged as TP
from lav_tpu_torch.train.distill import adam
from lav_tpu_torch.utils.tree import bn_state
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import (
    assert_close, check_grads, check_update, jax_tree,
)

B, LR, N_SEM_SEG = 4, 3e-4, 4
SEG_HW, BRA_HWS = (32, 32), ((64, 192), (64, 128))
SEG_TOL = dict(metric=1e-4, grad_norm=1e-2, leaf=1e-1, all=5e-2, floor=1e-6)
BRA_TOL = dict(SEG_TOL, grad_norm=1e-3, leaf=5e-2, all=2e-2)
STAT_TOL, TRAIN_LOGIT_ATOL, EVAL_ATOL = 1e-5, 5e-3, 1e-4
_MEAN, _STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _jax_masks(rng, erfnet, shape):
    """lav_tpu's dropout masks for an ERFNet input of NCHW `shape`, drawn
    from `rng` as erfnet_apply(train=True, rng) draws them, as NCHW bool
    tensors keyed like `ERFNet.draw_masks`."""
    names = [n for n in erfnet.block_names
             if isinstance(getattr(erfnet, n), NonBottleneck1d)]
    keys = dict(zip(names, jax.random.split(rng, len(names))))
    masks = {}
    for name, m in erfnet.draw_masks(torch.Generator(), shape).items():
        b, c, h, w = m.shape
        keep = 1.0 - getattr(erfnet, name).dropprob
        j = jax.random.bernoulli(keys[name], keep, (b, h, w, c))
        masks[name] = torch.from_numpy(np.array(j)).permute(0, 3, 1, 2)
    return masks


def _ref_step(loss_fn, opt):
    """A lav_tpu step body, jitted, with the gradients: loss_fn(params,
    rng) -> (loss, bn_state)."""
    @jax.jit
    def step(params, opt_state, rng):
        (loss, state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, rng)
        metrics = dict(loss=loss, grad_norm=optax.global_norm(grads))
        updates, opt_state = opt.update(grads, opt_state, params)
        params = j_merge_bn_state(optax.apply_updates(params, updates),
                                  state)
        return metrics, grads, params, opt_state

    return step


def _check_one_step(tag, make, loss_fn, port_step, tol):
    """One step of the port (`port_step(models, optimizer, rng)`) against
    lav_tpu's (`loss_fn`), both from the port's initialiser."""
    params = jax.tree.map(jnp.asarray,
                          jax_tree(make(torch.Generator().manual_seed(0))))
    opt = optax.adam(LR)
    rng = jax.random.key(7)
    metrics_j, grads, new_params, _ = _ref_step(loss_fn, opt)(
        params, opt.init(params), rng)
    models = load_jax_params(make(None), _tree(params))
    metrics = port_step(models, adam(models, LR), rng)
    as_port = lambda t: load_jax_params(make(None), _tree(t))  # noqa: E731
    check_grads(tag, models, metrics, metrics_j, as_port(grads), tol)
    check_update(tag, models, as_port(new_params), as_port(grads), 1e-7,
                 {}, LR, STAT_TOL)
    return models


def test_seg_step_matches_lav_tpu():
    batch = TP.seg_batch(B, N_SEM_SEG, seed=0, device="cpu", hw=SEG_HW)
    bj = _jax_batch(batch)

    def loss_fn(p, rng):
        logits, state = seg_model_apply(p, bj["rgb"], True, rng)
        return J_losses.cross_entropy(logits, bj["sem"]).mean(), state

    def port_step(models, optimizer, rng):
        masks = _jax_masks(rng, models.erfnet, (B, 3, *SEG_HW))
        return TP.make_seg_train_step(v1_config())(
            models, optimizer, batch, masks=masks)

    _check_one_step("rgb_train.seg", lambda g: SegModel(N_SEM_SEG, gen=g),
                    loss_fn, port_step, SEG_TOL)


@pytest.mark.parametrize("version", [1, 2])
def test_bra_step_matches_lav_tpu(version):
    batch = TP.bra_batch(B, seed=0, device="cpu", hws=BRA_HWS)
    bj = _jax_batch(batch)

    def loss_fn(p, rng):
        pred, sem1, sem2, state = brake_model_apply(
            p, bj["rgb"], bj["tel_rgb"], True, with_mask=True,
            version=version)
        loss = (J_losses.bce(pred, bj["bra"].astype(pred.dtype)).mean()
                + 0.5 * J_losses.cross_entropy(sem1, bj["sem"]).mean()
                + 0.5 * J_losses.cross_entropy(sem2, bj["tel_sem"]).mean())
        return loss, state

    def port_step(models, optimizer, rng):
        return TP.make_bra_train_step(v1_config(), version)(
            models, optimizer, batch)

    models = _check_one_step(
        f"rgb_train.bra_v{version}",
        lambda g: BrakeModel(version, gen=g),
        loss_fn, port_step, BRA_TOL)
    assert models.training and not bn_state(models)


def test_erfnet_train_with_masks_matches_lav_tpu():
    """ERFNet in train mode with lav_tpu's masks against
    erfnet_apply(train=True, rng): logits and every BN update; and a
    generator draws masks of the same shapes at the schedule's rates."""
    params = seg_model_init(jax.random.key(3), N_SEM_SEG)
    rng_np = np.random.default_rng(4)
    x = rng_np.uniform(-1, 1, (B, *SEG_HW, 3)).astype(np.float32)
    rng = jax.random.key(11)
    ref, state = erfnet_apply(params["erfnet"], jnp.asarray(x), True, rng)
    model = load_jax_params(SegModel(N_SEM_SEG), _tree(params)).train()
    erf = model.erfnet
    masks = _jax_masks(rng, erf, (B, 3, *SEG_HW))
    with torch.no_grad():
        out = erf(L.nhwc_to_nchw(torch.from_numpy(x)), masks=masks)
    assert_close("rgb_train.erfnet_train.logits", L.nchw_to_nhwc(out),
                 np.asarray(ref), atol=TRAIN_LOGIT_ATOL)
    got = bn_state(erf)
    want = jax.tree_util.tree_flatten_with_path(_tree(state))[0]
    assert len(want) == 2 * len(got)
    for path, val in want:
        keys = [k.key for k in path]
        mean, var = got[".".join(keys[:-1])]
        assert_close(f"rgb_train.erfnet_train.bn_{keys[-1]}",
                     mean if keys[-1] == "mean" else var, val,
                     atol=STAT_TOL, rtol=STAT_TOL)
    drawn = erf.draw_masks(torch.Generator().manual_seed(0),
                           (B, 3, *SEG_HW))
    assert {k: v.shape for k, v in drawn.items()} == {
        k: v.shape for k, v in masks.items()}
    assert len(drawn) == 13     # every encoder block; the decoder's rate is 0
    for name, m in drawn.items():
        keep = 1.0 - getattr(erf, name).dropprob
        assert m.dtype == torch.bool
        assert abs(m.float().mean().item() - keep) < 0.1, name


def test_brake_seg_head_round_trip():
    """The brake net's tree, seg head included, goes through
    load_jax_params and comes back from jax_tree unchanged, in lav_tpu's
    structure; the head's output matches lav_tpu's with_mask=True."""
    params = brake_model_init(jax.random.key(21), BRAKE_SEG_CHANNELS,
                              version=2)
    model = load_jax_params(BrakeModel(2), _tree(params))
    back = jax_tree(model)
    want = _tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    batch = TP.bra_batch(2, seed=3, device="cpu", hws=BRA_HWS)
    bj = _jax_batch(batch)
    ref = brake_model_apply(params, bj["rgb"], bj["tel_rgb"], False,
                            with_mask=True, version=2)
    with torch.no_grad():
        out = model(batch["rgb"], batch["tel_rgb"], with_mask=True)
    for name, o, r in zip(("pred", "sem1", "sem2"), out, ref[:3]):
        assert o.shape == r.shape
        assert_close(f"rgb_train.brake_with_mask.{name}", o, np.asarray(r),
                     atol=EVAL_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_brake_norm_buffers_equal_per_call_constants(dtype):
    """The normalisation constants, now buffers, give the brake output of
    the earlier form that built them per call with torch.tensor(...,
    dtype), bit for bit; they are no lav_tpu params."""
    model = BrakeModel(2, gen=torch.Generator().manual_seed(0))
    assert not set(model.state_dict()) & {"imagenet_mean", "imagenet_std"}
    rng = np.random.default_rng(6)
    rgb1 = torch.from_numpy(rng.uniform(0, 255, (2, 32, 96, 3))
                            .astype(np.float32)).to(dtype)
    rgb2 = torch.from_numpy(rng.uniform(0, 255, (2, 64, 64, 3))
                            .astype(np.float32)).to(dtype)
    for name, vals in (("imagenet_mean", _MEAN), ("imagenet_std", _STD)):
        assert torch.equal(getattr(model, name).to(dtype),
                           torch.tensor(vals, dtype=dtype))

    def per_call(x):
        return ((x / 255.0 - torch.tensor(_MEAN, dtype=x.dtype))
                / torch.tensor(_STD, dtype=x.dtype))

    with torch.no_grad():
        out = model(rgb1, rgb2)
        h = [model.attn1(resnet_apply(model.conv_backbone, per_call(rgb1))),
             model.attn2(resnet_apply(model.conv_backbone, per_call(rgb2)))]
        old = torch.sigmoid(model.classifier(torch.cat(h, -1)))[:, 0]
    assert torch.equal(out, old)
