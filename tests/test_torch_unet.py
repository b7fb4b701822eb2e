"""The port's UNet (`lav_tpu_torch/nn/unet.py`) against lav_tpu's
`unet_init` / `unet_apply` on the CPU, from lav_tpu's params converted by
`load_jax_params`: eval mode (BN on running statistics) and train mode
(BN on batch statistics: the logits, the updated running statistics and
every parameter's gradient of a weighted sum of the logits), in f32 at
atol 1e-4 / rtol 1e-4 (the gradients at rtol 1e-3 plus 1e-6 of the
largest: train-mode BN sums over the batch in another order, and a conv
bias before BN has a gradient of 0 up to rounding); and lav_tpu's
whole-tree int8 scope
over it, whose `upconv` subtrees stay float.  At lav_tpu's default four
widths (which its own init cannot build) the port's UNet runs in both
modes with the shapes lav_tpu's apply gives.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.nn import quant as JQ
from lav_tpu.nn import unet as JU
from lav_tpu_torch.nn import quant as Q
from lav_tpu_torch.nn.unet import UNet
from lav_tpu_torch.utils.tree import bn_state
from lav_tpu_torch.utils.weights import load_jax_params
from tests.test_torch_quant import _jax_int8
from tests.torch_parity import assert_close, jax_tree

# two levels: lav_tpu's unet_init splits 2 * len(widths) + 1 keys and
# takes 3 * len(widths) - 1, so it raises StopIteration from three widths
# on (its default four included); the port's UNet builds any
WIDTHS = (8, 16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup():
    params = jax.tree.map(np.asarray, JU.unet_init(jax.random.key(4), 3, 5,
                                                   WIDTHS))
    model = load_jax_params(UNet(3, 5, WIDTHS), params)
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 3)).astype(
        np.float32)
    return params, model, x


def test_unet_eval_matches_lav_tpu():
    params, model, x = _setup()
    # running statistics away from the init's (0, 1)
    rng = np.random.default_rng(1)
    for m in model.modules():
        if hasattr(m, "var") and isinstance(m.var, torch.Tensor):
            m.mean.uniform_(-0.2, 0.2, generator=torch.Generator()
                            .manual_seed(int(rng.integers(1 << 30))))
            m.var.uniform_(0.5, 1.5)
    params = jax_tree(model)
    want, _ = JU.unet_apply(params, jnp.asarray(x), False, WIDTHS)
    got = model(torch.from_numpy(x))
    assert got.shape == (2, 16, 24, 5)
    assert_close("unet.eval", got, want, atol=1e-4, rtol=1e-4)


def test_unet_train_matches_lav_tpu():
    params, model, x = _setup()
    w = np.random.default_rng(2).normal(size=(2, 16, 24, 5)).astype(
        np.float32)

    def loss(p):
        y, st = JU.unet_apply(p, jnp.asarray(x), True, WIDTHS)
        return jnp.sum(y * w), (y, st)

    (_, (want, state)), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model.train()
    got = model(torch.from_numpy(x))
    (got * torch.from_numpy(w)).sum().backward()
    assert_close("unet.train", got, want, atol=1e-4, rtol=1e-4)
    stats = bn_state(model)
    assert len(stats) == 2 * (2 * len(WIDTHS) - 1)
    for name, (mean, var) in stats.items():
        block, bn = name.split(".")
        assert_close(f"unet.{name}.mean", mean, state[block][bn]["mean"],
                     atol=1e-5, rtol=1e-4)
        assert_close(f"unet.{name}.var", var, state[block][bn]["var"],
                     atol=1e-5, rtol=1e-4)
    g = copy.deepcopy(model)
    for p, q in zip(g.parameters(), model.parameters()):
        p.data = q.grad.clone()
    want_g = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                              grads))
    got_g = dict(jax.tree_util.tree_leaves_with_path(jax_tree(g)))
    want_g = [(p, v) for p, v in want_g
              if p[-1].key not in ("mean", "var")]   # buffers, no gradient
    # a conv bias before train-mode BN has a gradient of 0 up to rounding:
    # each leaf within 1e-3 of itself plus 1e-6 of the largest gradient
    top = max(float(np.abs(v).max()) for _, v in want_g)
    for path, leaf in want_g:
        assert_close(f"unet.grad{jax.tree_util.keystr(path)}", got_g[path],
                     leaf, atol=1e-6 * top, rtol=1e-3)


def test_unet_int8_scope_keeps_the_upconvs_float():
    params, model, _ = _setup()
    want = set(_jax_int8(jax.tree.map(np.asarray,
                                      JQ.quantize_tree(params))))
    got = {p for p, _ in Q.int8_convs(Q.quantize_tree(model))}
    assert got == want and got
    assert not any("upconv" in p for p in got)
    assert "/down_0/conv1" not in got       # the 3-channel stem


def test_unet_default_widths_build_and_run():
    model = UNet(3, 5, gen=torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 16, 3), generator=torch.Generator().manual_seed(1))
    for train in (False, True):
        model.train(train)
        y = model(x)
        assert y.shape == (2, 32, 16, 5) and torch.isfinite(y).all()
