"""The port's copy of the LiDAR point budget (`lav_tpu_torch/utils/
point_budget.py`) against lav_tpu's `utils/point_budget.py`: the same
numbers exactly, and the brackets lav_tpu's own test holds
(`tests/test_observability_extra.py::test_point_budget_brackets`)."""

import json

import pytest

from lav_tpu.utils import point_budget as J
from lav_tpu_torch.utils import point_budget as T


def test_summary_equals_lav_tpu():
    assert T.summary() == J.summary()


@pytest.mark.parametrize("ground_z", [0.0, -0.5, 1.0])
def test_flat_world_sweep_equals_lav_tpu(ground_z):
    assert T.flat_world_sweep(ground_z) == J.flat_world_sweep(ground_z)


def test_constants_equal_lav_tpu():
    names = ("POINTS_PER_SECOND", "ROTATION_HZ", "CHANNELS", "UPPER_FOV_DEG",
             "LOWER_FOV_DEG", "RANGE_M", "TICK_HZ", "SENSOR_Z", "BEV_X",
             "BEV_Y", "N_STACK", "V2_CAP", "DROPOFF_GENERAL_RATE")
    assert {n: getattr(T, n) for n in names} == \
        {n: getattr(J, n) for n in names}
    assert T.rays_per_fused_sweep() == J.rays_per_fused_sweep() == 60_000


def test_point_budget_brackets():
    s = T.summary()
    assert s["stacked_flat_world"] <= s["v2_config_cap"] == 120_000
    assert s["stacked_flat_world"] >= 60_000 * 0.8
    per_sweep = s["stacked_flat_world"] / 3
    assert 0 < per_sweep <= 60_000
    assert s["flat_world_in_bev_box"] <= s["geometric_in_box_cap"] <= \
        s["rays_per_fused_sweep"]


def test_main_prints_the_summary(capsys):
    T.main()
    out = capsys.readouterr().out
    table = out[:out.index("\n}") + 2]
    assert json.loads(table) == J.summary()
    assert "bench operating points: 60,000 default, 120,000 max" in out
