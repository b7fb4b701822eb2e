"""Photometric augmentation in pure numpy (no imgaug).

Re-creates the reference augmentation distribution
(LAV's lav/utils/augmenter.py:4-17): each op applied with
probability p in random order — gaussian blur, additive gaussian noise,
coarse dropout, channel multiply, linear contrast, partial grayscale, and
elastic warp (imgaug ElasticTransformation semantics: gaussian-smoothed
random displacement field, alpha in (0.5, 3.5) px, sigma 0.25).
"""

from __future__ import annotations

import numpy as np


def _blur(rng, img):
    sigma = rng.uniform(0, 0.5)
    if sigma < 1e-3:
        return img
    radius = 2
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    out = img.astype(np.float32)
    pad = np.pad(out, ((radius, radius), (0, 0), (0, 0)), mode="edge")
    out = sum(k[i] * pad[i:i + img.shape[0]] for i in range(len(k)))
    pad = np.pad(out, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    out = sum(k[i] * pad[:, i:i + img.shape[1]] for i in range(len(k)))
    return out


def _noise(rng, img):
    scale = rng.uniform(0, 0.05 * 255)
    per_channel = rng.random() < 0.5
    shape = img.shape if per_channel else img.shape[:2] + (1,)
    return img + rng.normal(0, scale, shape)


def _dropout(rng, img):
    p = rng.uniform(0.01, 0.1)
    per_channel = rng.random() < 0.5
    shape = img.shape if per_channel else img.shape[:2] + (1,)
    return img * (rng.random(shape) >= p)


def _multiply(rng, img):
    per_channel = rng.random() < 0.5
    n = img.shape[-1] if per_channel else 1
    m = rng.uniform(1 / 1.2, 1.2, (1, 1, n))
    return img * m


def _contrast(rng, img):
    per_channel = rng.random() < 0.5
    n = img.shape[-1] if per_channel else 1
    a = rng.uniform(1 / 1.2, 1.2, (1, 1, n))
    return (img - 127.0) * a + 127.0


def _grayscale(rng, img):
    alpha = rng.uniform(0.0, 0.5)
    gray = img.mean(axis=-1, keepdims=True)
    return (1 - alpha) * img + alpha * gray


def _elastic(rng, img):
    """imgaug ElasticTransformation(alpha=(0.5, 3.5), sigma=0.25): sample a
    uniform(-1, 1) displacement field per axis, gaussian-smooth it with
    `sigma`, scale by `alpha` px, and bilinearly resample.  At sigma 0.25
    the smoothing kernel is ~1 px, i.e. near-independent jitter per pixel."""
    alpha = rng.uniform(0.5, 3.5)
    sigma = 0.25
    h, w = img.shape[:2]

    radius = max(int(3 * sigma), 1)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k /= k.sum()

    def smooth(field):
        pad = np.pad(field, radius, mode="reflect")
        out = sum(k[i] * pad[i:i + h, radius:radius + w]
                  for i in range(len(k)))
        pad = np.pad(out, radius, mode="reflect")
        return sum(k[i] * pad[radius:radius + h, i:i + w]
                   for i in range(len(k)))

    dy = smooth(rng.uniform(-1, 1, (h, w))) * alpha
    dx = smooth(rng.uniform(-1, 1, (h, w))) * alpha

    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    sy = np.clip(yy + dy, 0, h - 1)
    sx = np.clip(xx + dx, 0, w - 1)
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, h - 2)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, w - 2)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    out = (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx)
        + img[y0 + 1, x0 + 1] * fy * fx
    )
    return out


_OPS = (_blur, _noise, _dropout, _multiply, _contrast, _grayscale, _elastic)


class Augmenter:
    def __init__(self, prob: float = 0.5, seed: int = 0):
        self.prob = prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img (H, W, 3) uint8 -> augmented uint8."""
        out = img.astype(np.float32)
        order = self.rng.permutation(len(_OPS))
        for i in order:
            if self.rng.random() < self.prob:
                out = _OPS[i](self.rng, out)
        return np.clip(out, 0, 255).astype(np.uint8)
