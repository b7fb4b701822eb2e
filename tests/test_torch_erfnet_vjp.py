"""The backward of the camera nets' train-mode blocks against `jax.vjp` of
lav_tpu's, one block at a time, in f32 on the CPU: ERFNet's
`NonBottleneck1d` (dilation 1 and 4, with a dropout mask drawn from
lav_tpu's key), its `Downsampler` and `Upsampler`
(lav_tpu/nn/erfnet.py), and the brake net's `SegHead`
(lav_tpu/models/rgb.py `_seg_head`).

The camera steps' gradients are held only loosely
(tests/test_torch_rgb_train.py: 10% and 5% a leaf), because the whole
nets amplify rounding at test size.  A block does not: the same params
(from the port's initialisers through `torch_parity.jax_tree`), input and
output gradient go through both, and each block's input gradient, every
parameter gradient and its BN state update are held to 1e-5 of their
largest magnitude plus 1e-6 (f32 sums in another order; measured <= 1.4e-6
of it), the parameter gradients with a floor of 4e-6 of the block's
largest parameter gradient instead (a bias before a BatchNorm has an exact
gradient of 0, whose f32 value is noise: measured 1.1e-6 of it), and the
block's output to atol 1e-5 (measured <= 2.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lav_tpu.models.rgb import _seg_head
from lav_tpu.nn import erfnet as JE
from lav_tpu_torch.models.rgb import SegHead
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.erfnet import Downsampler, NonBottleneck1d, Upsampler
from lav_tpu_torch.utils.tree import bn_state
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close, jax_tree

REL, FLOOR = 1e-5, 4e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _blocks():
    """(label, port module, lav_tpu apply(p, x, rng) -> (y, state), NHWC
    input shape, rng for dropout or None)."""
    g = torch.Generator().manual_seed(0)
    nb = NonBottleneck1d(16, 4, 0.3, gen=g)
    return [
        ("non_bt_1d dilation 1", NonBottleneck1d(16, 1, gen=g),
         lambda p, x, rng: JE.non_bt_1d(p, x, True, 1, 0.0),
         (2, 12, 10, 16), None),
        ("non_bt_1d dilation 4, dropout 0.3", nb,
         lambda p, x, rng: JE.non_bt_1d(p, x, True, 4, 0.3, rng),
         (2, 12, 10, 16), jax.random.key(3)),
        ("downsampler", Downsampler(16, 32, gen=g),
         lambda p, x, rng: JE.downsampler(p, x, True), (2, 12, 10, 16),
         None),
        ("upsampler", Upsampler(32, 16, gen=g),
         lambda p, x, rng: JE.upsampler(p, x, True), (2, 6, 5, 32), None),
        ("seg_head", SegHead(64, 5, gen=g),
         lambda p, x, rng: _seg_head(p, x, True), (2, 3, 4, 64), None),
    ]


def _close(name, got, want, floor=1e-6):
    want = _t(want)
    assert_close(name, got, want, atol=REL * float(want.abs().max()) + floor)


@pytest.mark.parametrize("index", range(5), ids=[b[0] for b in _blocks()])
def test_block_backward_matches_jax_vjp(index):
    label, block, j_apply, shape, rng = _blocks()[index]
    r = np.random.default_rng(40 + index)
    x = r.normal(size=shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, jax_tree(block))

    (y, st), vjp = jax.vjp(lambda p, xx: j_apply(p, xx, rng), params,
                           jnp.asarray(x))
    g = r.normal(size=y.shape).astype(np.float32)
    d_p, d_x = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, st)))

    block = load_jax_params(block, jax.tree.map(np.asarray, params)).train()
    nhwc = isinstance(block, SegHead)
    tx = _t(x).requires_grad_(True)
    xin = tx if nhwc else L.nhwc_to_nchw(tx)
    if rng is None:
        out = block(xin)
    else:   # lav_tpu's mask, drawn on the NHWC output, handed over NCHW
        keep = 1.0 - block.dropprob
        mask = jax.random.bernoulli(rng, keep, y.shape)
        out = block(xin, _t(mask).permute(0, 3, 1, 2))
    out = out if nhwc else L.nchw_to_nhwc(out)
    out.backward(_t(g))
    assert_close(f"erfnet_vjp.{label}.y", out.detach(), y, atol=1e-5)
    _close(f"erfnet_vjp.{label}.dx", tx.grad, d_x)
    # a second copy of the block holds lav_tpu's parameter gradients
    want = load_jax_params(_blocks()[index][1], jax.tree.map(np.asarray, d_p))
    grads = {n: p.detach() for n, p in want.named_parameters()}
    # a bias before a BatchNorm has an exact gradient of 0: f32 noise
    floor = FLOOR * max(float(v.abs().max()) for v in grads.values())
    for name, p in block.named_parameters():
        _close(f"erfnet_vjp.{label}.d{name}", p.grad, grads[name], floor)
    state = bn_state(block)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(st)[0]:
        keys = [k.key for k in path]
        flat[(".".join(keys[:-1]), keys[-1])] = leaf
    for name, (mean, var) in state.items():
        _close(f"erfnet_vjp.{label}.{name}.mean", mean, flat[(name, "mean")])
        _close(f"erfnet_vjp.{label}.{name}.var", var, flat[(name, "var")])
    assert len(state) == len(flat) // 2
