"""The port's paint pass (lav_tpu_torch.train.paint) against lav_tpu's on
the CPU, at tiny_config: the same seg weights (the port's initialiser,
lav_tpu's tree through `torch_parity.jax_tree`) paint the same synthetic
in-memory episodes, and each frame's committed `lidar_sem` must match
lav_tpu's to PAINT_ATOL (softmax probabilities of the same ERFNet in f32:
the convolutions' sums differ in order; measured <= 4.5e-8), with the
same points painted (a point no camera sees is exactly 0 on both sides).
Once with camera rigs of the images' size, and once with lav_tpu's
default rigs of 288x256 over smaller images, where a projected index can
land past the maps (lav_tpu's gather gives 0 there) or in a later
camera's map.
"""

import jax
import numpy as np
import pytest
import torch

from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu.data.store import make_synthetic_episode as j_episode
from lav_tpu.train.paint import run_paint as j_run_paint
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.data.store import make_synthetic_episode
from lav_tpu_torch.models.rgb import SegModel
from lav_tpu_torch.train.paint import run_paint
from tests.torch_parity import assert_close, jax_tree

HW = (48, 64)
PAINT_ATOL = 1e-5
EPISODE = dict(n_frames=6, n_lidar=400, img_hw=HW, bev_hw=(32, 32))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("rgb_hw", [HW, (288, 256)],
                         ids=["rigs_of_the_images", "larger_rigs"])
def test_run_paint_matches_lav_tpu(rgb_hw):
    # a wide lidar range (the synthetic sweep is +-30 m) keeps most points
    # in some camera's view
    model = SegModel(4, torch.Generator().manual_seed(0))
    params = jax.tree.map(jax.numpy.asarray, jax_tree(model))
    j_eps = [j_episode(seed=s, **EPISODE) for s in (0, 1)]
    t_eps = [make_synthetic_episode(seed=s, **EPISODE) for s in (0, 1)]
    n_j = j_run_paint(j_tiny_config(), params, j_eps, max_points=512,
                      rgb_hw=rgb_hw)
    n_t = run_paint(tiny_config(), model, t_eps, max_points=512,
                    rgb_hw=rgb_hw)
    assert n_j == n_t == 2 * (EPISODE["n_frames"] - tiny_config().num_plan)
    painted = 0
    for je, te in zip(j_eps, t_eps):
        for t in range(n_t // 2):
            key = f"lidar_sem_{t:05d}".encode()
            want = np.frombuffer(je.store.get(key), np.float32).reshape(
                -1, 4)
            got = np.frombuffer(te.store.get(key), np.float32).reshape(
                -1, 4)
            assert np.array_equal(got == 0, want == 0), t
            assert_close(f"paint.{rgb_hw[0]}x{rgb_hw[1]}", got, want,
                         atol=PAINT_ATOL)
            painted += int((want != 0).any(-1).sum())
    assert painted > 100
