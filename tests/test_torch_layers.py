"""lav_tpu_torch.nn against lav_tpu.nn on the CPU, layer by layer.

The same inputs, drawn with numpy from a seed, go through the JAX layer
and its port; the JAX params are converted by the port's weight loader.
f32 throughout, atol 1e-5 for single layers (summation order only) and
1e-4 for whole backbones (deeper sums).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lav_tpu.nn import layers as JL
from lav_tpu.nn.attention import attention_apply, attention_init
from lav_tpu.nn.erfnet import erfnet_apply, erfnet_init
from lav_tpu.nn.resnet import resnet_apply as j_resnet_apply, resnet18_init
from lav_tpu_torch.nn import layers as L
from lav_tpu_torch.nn.attention import AttentionPool
from lav_tpu_torch.nn.erfnet import ERFNet
from lav_tpu_torch.nn.resnet import resnet18, resnet_apply
from lav_tpu_torch.utils.weights import load_jax_params
from tests.torch_parity import assert_close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _load(module, tree):
    return load_jax_params(module, _np(tree)).eval().requires_grad_(False)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


def test_linear(rng):
    p = JL.linear_init(jax.random.key(0), 7, 5)
    x = rng.normal(size=(3, 4, 7)).astype(np.float32)
    m = _load(L.Linear(7, 5), p)
    assert_close("layers.linear", m(_t(x)), JL.linear(p, jnp.asarray(x)),
                 atol=1e-5)


@pytest.mark.parametrize("ksize,stride,padding,dilation", [
    (3, 1, 1, 1), (3, 2, 1, 1), ((3, 1), 1, (2, 0), (2, 1)),
    ((1, 3), 1, (0, 4), (1, 4)), (7, 2, 3, 1), (1, 2, 0, 1)])
def test_conv2d(rng, ksize, stride, padding, dilation):
    p = JL.conv2d_init(jax.random.key(1), 6, 5, ksize, bias=True)
    x = rng.normal(size=(2, 13, 11, 6)).astype(np.float32)
    m = _load(L.Conv2d(6, 5, ksize, stride, padding, dilation), p)
    ref = JL.conv2d(p, jnp.asarray(x), stride=stride, padding=padding,
                    dilation=dilation)
    assert_close("layers.conv2d", _nhwc(m(_nchw(x))), ref, atol=1e-5)


@pytest.mark.parametrize("ksize,stride,padding,output_padding", [
    (3, 2, 1, 1), (4, 2, 1, 0), (4, 4, 1, 2), (1, 1, 0, 0), (2, 2, 0, 0)])
def test_conv_transpose2d(rng, ksize, stride, padding, output_padding):
    p = JL.conv_transpose2d_init(jax.random.key(2), 6, 4, ksize, bias=True)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    m = _load(L.ConvTranspose2d(6, 4, ksize, stride, padding,
                                output_padding), p)
    ref = JL.conv_transpose2d(p, jnp.asarray(x), stride=stride,
                              padding=padding, output_padding=output_padding)
    assert_close("layers.conv_transpose2d", _nhwc(m(_nchw(x))), ref,
                 atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_eval(rng, eps):
    c = 6
    p = {"scale": jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32),
         "bias": jnp.asarray(rng.normal(size=c), jnp.float32),
         "mean": jnp.asarray(rng.normal(size=c), jnp.float32),
         "var": jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32)}
    x = rng.normal(size=(2, 4, 5, c)).astype(np.float32)
    ref = np.asarray(JL.batchnorm_apply(p, jnp.asarray(x), False, eps=eps))
    chan_first = _load(L.BatchNorm(c, eps=eps), p)
    chan_last = _load(L.BatchNorm(c, eps=eps, dim=-1), p)
    assert_close("layers.batchnorm", _nhwc(chan_first(_nchw(x))), ref,
                 atol=1e-5)
    assert_close("layers.batchnorm", chan_last(_t(x)), ref, atol=1e-5)


def test_gru(rng):
    p = JL.gru_init(jax.random.key(3), 4, 16)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    h0 = rng.normal(size=(3, 16)).astype(np.float32)
    ref_out, ref_h = JL.gru(p, jnp.asarray(x), jnp.asarray(h0))
    m = _load(L.GRU(4, 16), p)
    out, h = m(_t(x), _t(h0))
    assert_close("layers.gru", out, ref_out, atol=1e-5)
    assert_close("layers.gru", h, ref_h, atol=1e-5)


def test_gru_and_linear_banks(rng):
    n = 3
    keys = jax.random.split(jax.random.key(4), n)
    gp = jax.vmap(lambda k: JL.gru_init(k, 8, 5))(keys)
    lp = jax.vmap(lambda k: JL.linear_init(k, 5, 2))(keys)
    x = rng.normal(size=(2, 4, 8)).astype(np.float32)
    ref = jax.vmap(lambda g, l: JL.linear(l, JL.gru(g, jnp.asarray(x))[0]))(
        gp, lp)
    bank = _load(L.GRUBank(n, 8, 5), gp)
    lbank = _load(L.LinearBank(n, 5, 2), lp)
    out = lbank(bank(_t(x)))
    assert_close("layers.gru_bank", out, ref, atol=1e-5)


@pytest.mark.parametrize("ksize,stride,padding", [(3, 2, 1), (2, 2, 0),
                                                  (7, 1, 3)])
def test_max_pool2d(rng, ksize, stride, padding):
    # all-negative values: a zero-padded pool would differ from -inf
    x = -np.abs(rng.normal(size=(2, 9, 10, 3))).astype(np.float32) - 1.0
    ref = JL.max_pool2d(jnp.asarray(x), ksize, stride, padding)
    out = L.max_pool2d(_t(x), ksize, stride, padding)
    assert_close("layers.max_pool2d", out, ref, atol=0.0)


def test_interpolate_nearest(rng):
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    assert_close("layers.interpolate_nearest", L.interpolate_nearest(_t(x), 4),
                 JL.interpolate_nearest(jnp.asarray(x), 4), atol=0.0)


@pytest.mark.parametrize("cin", [3, 48])
def test_resnet18(rng, cin):
    p = resnet18_init(jax.random.key(5), cin)
    x = rng.normal(size=(2, 32, 32, cin)).astype(np.float32)
    ref, _ = j_resnet_apply(p, jnp.asarray(x), False)
    net = _load(resnet18(cin), p)
    with torch.no_grad():
        out = resnet_apply(net, _t(x))
    assert_close("nn.resnet18", out, ref, atol=1e-4, rtol=1e-4)


def test_erfnet(rng):
    p = erfnet_init(jax.random.key(6), 5)
    x = rng.uniform(-1, 1, size=(1, 32, 48, 3)).astype(np.float32)
    ref, _ = erfnet_apply(p, jnp.asarray(x), False)
    net = _load(ERFNet(5), p)
    with torch.no_grad():
        out = _nhwc(net(_nchw(x)))
    assert_close("nn.erfnet", out, ref, atol=1e-4, rtol=1e-4)


def test_attention_pool(rng):
    p = attention_init(jax.random.key(7), 64)
    x = rng.normal(size=(2, 3, 5, 64)).astype(np.float32)
    ref = attention_apply(p, jnp.asarray(x))
    m = _load(AttentionPool(64), p)
    with torch.no_grad():
        out = m(_t(x))
    assert_close("nn.attention", out, ref, atol=1e-5)


def test_loader_rejects_mismatch():
    p = JL.conv2d_init(jax.random.key(8), 6, 5, 3)
    with pytest.raises(ValueError):
        load_jax_params(L.Conv2d(6, 4, 3), _np(p))
    with pytest.raises(KeyError):
        load_jax_params(L.Conv2d(6, 5, 3, bias=True),
                        {"w": np.asarray(p["w"])})
