"""The port's v1 distillation step in mode "motion_only" against
lav_tpu's: the check, setup and tolerances of
tests/test_torch_train_modes.py."""

import pytest
import torch

from tests import test_torch_train_modes as M


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_v1_motion_only_matches_lav_tpu():
    M.check_v1_mode("motion_only")
