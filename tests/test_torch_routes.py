"""The port's route replay (lav_tpu_torch.agent.routes, route, evaluate's
evaluate_routes and make_route_results) against lav_tpu's on the CPU.

LAV's validation routes are not in the repository, so the test writes a
route file in the leaderboard's format: one route with a 90 degree turn,
one with a lateral lane change, with the literal "\\n" escapes that LAV's
shipped files carry between waypoint tags.  Parsing, densifying and the
command plan are numpy on both sides and must be equal.  The replay runs
both agents (`det_override`, the scripted traffic; lav_tpu's weights with
its eval priors) for 40 ticks a route and the reversed legs: counts and
command histograms equal, completion and plan progress to 1e-6.
"""

import json

import jax
import numpy as np
import pytest
import torch

from lav_tpu.agent import evaluate as JV
from lav_tpu.agent import routes as JR
from lav_tpu.agent.agent import build_agent as j_build_agent
from lav_tpu.agent.demo import build_params as j_build_params
from lav_tpu.config import tiny_config as j_tiny_config
from lav_tpu_torch.agent import evaluate, routes
from lav_tpu_torch.agent.agent import AgentModels
from lav_tpu_torch.config import tiny_config
from lav_tpu_torch.utils.weights import load_jax_params

ROUTES = {
    "turn": [(0, 0), (60, 0), (120, 0), (120, 60), (120, 120)],
    "lane_change": [(0, 0), (60, 0), (85, 3.5), (150, 3.5)],
}
KW = dict(max_ticks=40, speed=25.0, max_points=64, rgb_hw=(32, 32),
          tel_hw=(24, 48))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def write_routes(path, town="Town05"):
    """A leaderboard route file of ROUTES, waypoints joined by literal
    backslash-n escapes."""
    body = []
    for i, wps in enumerate(ROUTES.values()):
        pts = "\\n".join(
            f'<waypoint pitch="0.0" roll="0.0" x="{x}" y="{y}" '
            f'yaw="{15.0 * i}" z="0.0"/>'
            for x, y in wps)
        body.append(f'<route id="{i}" town="{town}">{pts}</route>')
    path.write_text('<?xml version="1.0"?>\n<routes>\n' + "\n".join(body)
                    + "\n</routes>\n")
    return str(path)


def _with_reversed(rs):
    return rs + [dict(r, id=f"{r['id']}_rev", waypoints=r["waypoints"][::-1],
                      yaws=r["yaws"][::-1]) for r in rs]


def test_route_parsing_and_plans_match_lav_tpu(tmp_path):
    path = write_routes(tmp_path / "routes.xml")
    want, got = JR.parse_routes(path), routes.parse_routes(path)
    assert len(got) == len(ROUTES)
    for g, w in zip(got, want):
        assert (g["id"], g["town"]) == (w["id"], w["town"])
        np.testing.assert_array_equal(g["waypoints"], w["waypoints"])
        np.testing.assert_array_equal(g["yaws"], w["yaws"])
    cmds = set()
    for g, w in zip(_with_reversed(got), _with_reversed(want)):
        for a, b in zip(routes.interpolate_route(g),
                        JR.interpolate_route(w)):
            np.testing.assert_array_equal(a, b)
        gp, gd, gh = routes.dense_route_plan(g)
        wp, wd, wh = JR.dense_route_plan(w)
        assert gp == wp
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gh, wh)
        cmds |= set(routes.interpolate_route(g)[2].tolist())
    # a left and a right turn, both lane changes, and lane following
    assert {1, 2, 4, 5, 6} <= cmds, cmds
    assert routes.world_to_gps(100.0, -50.0) == JR.world_to_gps(100.0, -50.0)


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    path = write_routes(tmp_path_factory.mktemp("r") / "routes.xml")
    jcfg, tcfg = j_tiny_config(), tiny_config()
    params = j_build_params(jcfg, eval_priors=True)
    init_j, step_j = j_build_agent(jcfg, max_points=64, rgb_hw=(32, 32))
    want = JV.evaluate_routes(jcfg, params,
                              _with_reversed(JR.parse_routes(path)), step_j,
                              init_j, **KW)
    models = load_jax_params(AgentModels(tcfg, brake_version=1),
                             jax.tree.map(np.asarray, params)).eval()
    got = evaluate.evaluate_routes(tcfg, models,
                                   _with_reversed(routes.parse_routes(path)),
                                   **KW)
    return path, want, got


def test_evaluate_routes_matches_lav_tpu(replay):
    _, want, got = replay
    assert len(got) == len(want) == 2 * len(ROUTES)
    for g, w in zip(got, want):
        for k in ("ticks", "nan_controls", "brakes", "collides",
                  "collide_releases", "cmd_hist", "route_id", "town"):
            assert g[k] == w[k], (w["route_id"], k, g[k], w[k])
        for k in ("route_completion", "plan_progress"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
        assert set(g["latency"]) == set(w["latency"])
        assert g["nan_controls"] == 0 and g["plan_progress"] > 80.0
        assert 3 in g["cmd_hist"] and len(g["cmd_hist"]) > 1, g["cmd_hist"]
    # the scripted crossing triggers the collision forecast and releases it
    assert sum(g["collide_releases"] for g in got) > 0


def test_route_results_match_lav_tpu(replay):
    _, want, got = replay
    assert (evaluate.make_route_results(want)
            == JV.make_route_results(want))
    res = evaluate.make_route_results(got)
    recs = res["_checkpoint"]["records"]
    assert [r["route_id"] for r in recs] == [
        f"RouteScenario_{g['route_id']}" for g in got]
    assert recs[0]["status"] == "Completed"
    assert 0 < recs[0]["scores"]["score_route"] <= 100.0
    json.dumps(res)


def test_main_replays_routes_on_the_cpu(replay, tmp_path):
    path = replay[0]
    out = tmp_path / "results.json"
    res = evaluate.main(["--tiny", "--device", "cpu", "--routes", path,
                         "--ticks", "12", "--max-points", "64",
                         "--route-speed", "25", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    ids = [r["route_id"] for r in res["_checkpoint"]["records"]]
    assert ids == ["RouteScenario_0", "RouteScenario_1",
                   "RouteScenario_0_rev", "RouteScenario_1_rev"]
