"""Leaderboard route-file parsing (assets/routes_lav_*.xml format; a copy
of `lav_tpu/agent/routes.py`).

Parses the evaluation route XML LAV ships
(assets/routes_lav_valid.xml: <route id town> with
<waypoint x y z yaw .../>) into world-frame waypoint arrays and, for the
replay/sim evaluators, into the (gnss, command) global-plan format the
Waypointer consumes (CARLA's equirectangular GPS convention with the map
origin at lat=lon=0).
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

EARTH_RADIUS = 6371e3
LANEFOLLOW = 4  # RoadOption value


def parse_routes(path: str) -> List[Dict]:
    """-> [{'id': str, 'town': str, 'waypoints': (N, 3) xyz, 'yaws': (N,)}]"""
    # the shipped files contain literal "\n" escapes between waypoint tags;
    # normalize before XML parsing
    with open(path) as f:
        text = f.read().replace("\\n", " ")
    root = ET.fromstring(text)
    routes = []
    for r in root.iter("route"):
        wps, yaws = [], []
        for w in r.iter("waypoint"):
            wps.append([float(w.get("x")), float(w.get("y")),
                        float(w.get("z", 0.0))])
            yaws.append(math.radians(float(w.get("yaw", 0.0))))
        routes.append(dict(
            id=r.get("id"), town=r.get("town"),
            waypoints=np.asarray(wps), yaws=np.asarray(yaws),
        ))
    return routes


def world_to_gps(x: float, y: float) -> Tuple[float, float]:
    """CARLA world xy -> lat/lon with the default map geo-reference
    (origin at 0N 0E; the inverse of the agents' latlon_to_xy with cos0=0)."""
    lat = x / EARTH_RADIUS / (math.pi / 180.0)
    lon = y / EARTH_RADIUS / (math.pi / 180.0)
    return lat, lon


def route_to_global_plan(route: Dict, cmd: int = LANEFOLLOW):
    """Route dict -> [(gnss dict, RoadOption value)] for Waypointer /
    RoutePlanner.  Sparse route files carry no per-waypoint commands; the
    live leaderboard interpolates them — here every waypoint defaults to
    LANEFOLLOW, which is what the dense RoutePlanner needs."""
    plan = []
    for x, y, _ in route["waypoints"]:
        lat, lon = world_to_gps(x, y)
        plan.append(({"lat": lat, "lon": lon}, cmd))
    return plan


LEFT, RIGHT, STRAIGHT = 1, 2, 3
CHANGELANELEFT, CHANGELANERIGHT = 5, 6


def interpolate_route(route: Dict, spacing: float = 5.0,
                      turn_deg: float = 25.0, lookahead: float = 15.0,
                      straight_deg: float = 10.0):
    """Densify a sparse route polyline at `spacing` meters and derive
    per-point RoadOption commands from the geometry.

    The live leaderboard densifies routes with the CARLA map's road
    topology (interpolate_trajectory) and labels junction arcs with
    LEFT/RIGHT/STRAIGHT and lane changes with CHANGELANELEFT/RIGHT;
    without the map, the same labels are derived geometrically (the
    replay must exercise every command the agent handles):

      |heading change over lookahead| > turn_deg          -> LEFT/RIGHT
      straight_deg < |heading change| <= turn_deg         -> STRAIGHT
                                                             (gentle junction
                                                             arc proxy)
      |heading change| <= straight_deg AND 2.2-6 m of     -> CHANGELANELEFT/
      lateral jog in the local heading frame                 RIGHT (an
                                                             S-shaped offset
                                                             with heading
                                                             restored is a
                                                             lane change; the
                                                             real
                                                             routes_lav_valid
                                                             set contains one,
                                                             routes 12-15)

    Returns (dense_xy (N, 2), headings (N,), cmds (N,)).
    """
    wp = np.asarray(route["waypoints"])[:, :2]
    segs = np.diff(wp, axis=0)
    seg_len = np.linalg.norm(segs, axis=1)
    keep = seg_len > 1e-6
    segs, seg_len, starts = segs[keep], seg_len[keep], wp[:-1][keep]

    dense = []
    for s0, seg, ln in zip(starts, segs, seg_len):
        n = max(1, int(ln // spacing))
        for i in range(n):
            dense.append(s0 + seg * (i / n))
    dense.append(wp[-1])
    dense = np.asarray(dense)

    d = np.diff(dense, axis=0)
    headings = np.arctan2(d[:, 1], d[:, 0])
    headings = np.append(headings, headings[-1])

    n_ahead = max(1, int(lookahead // spacing))
    cmds = np.full(len(dense), LANEFOLLOW, np.int32)
    for i in range(len(dense) - 1):
        j = min(i + n_ahead, len(dense) - 1)
        dh = headings[j] - headings[i]
        dh = (dh + math.pi) % (2 * math.pi) - math.pi
        if abs(dh) > math.radians(turn_deg):
            cmds[i] = LEFT if dh > 0 else RIGHT
        elif abs(dh) > math.radians(straight_deg):
            cmds[i] = STRAIGHT
        else:
            # lateral jog in the local heading frame with heading restored;
            # a lane change completes over ~25 m, so it needs a longer
            # baseline than the turn lookahead (the real jog in
            # routes_lav_valid spans ~3.7 m of offset over 5 points)
            j2 = min(i + n_ahead + 2, len(dense) - 1)
            dh2 = headings[j2] - headings[i]
            dh2 = (dh2 + math.pi) % (2 * math.pi) - math.pi
            disp = dense[j2] - dense[i]
            lat = (-math.sin(headings[i]) * disp[0]
                   + math.cos(headings[i]) * disp[1])
            if abs(dh2) < math.radians(straight_deg) and 2.2 < abs(lat) < 6.0:
                # sign convention matches the turn labels (dh > 0 = LEFT)
                cmds[i] = CHANGELANELEFT if lat > 0 else CHANGELANERIGHT
    return dense, headings, cmds


def dense_route_plan(route: Dict, spacing: float = 5.0):
    """-> (global_plan [(gnss, cmd)], dense_xy, headings) — the
    leaderboard-format plan for Waypointer/RoutePlanner over the densified
    route with geometrically derived commands."""
    dense, headings, cmds = interpolate_route(route, spacing)
    plan = []
    for (x, y), cmd in zip(dense, cmds):
        lat, lon = world_to_gps(x, y)
        plan.append(({"lat": lat, "lon": lon}, int(cmd)))
    return plan, dense, headings
