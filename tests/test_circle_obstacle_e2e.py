"""End-to-end drive around CIRCLE and POLYGON obstacles (exact shapes).

pycrcc collides exact circles (reference reactive_planner.py:236-239).
This drives a synthetic scenario where a parked disc blocks the lane: the
facade must compile the circle into a disc row, swerve around it with a
small clearance, reach the goal, and validate collision-free — on both the
XLA f64 conformance path and the fused-scorer fast path (which runs the
same exact closest-point test).  The corner-region divergence against the
round-1 bounding-square over-approximation is unit-pinned separately in
tests/test_collision_shapes.py.
"""

import logging
import textwrap

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

_SCENARIO = """\
<?xml version="1.0" encoding="utf-8"?>
<commonRoad timeStepSize="0.1" commonRoadVersion="2020a" benchmarkID="SYN_Disc-1_1">
  <lanelet id="1">
    <leftBound>
      <point><x>0</x><y>4.0</y></point>
      <point><x>120</x><y>4.0</y></point>
    </leftBound>
    <rightBound>
      <point><x>0</x><y>-4.0</y></point>
      <point><x>120</x><y>-4.0</y></point>
    </rightBound>
  </lanelet>
  <staticObstacle id="10">
    <type>unknown</type>
    <shape><circle><radius>1.8</radius></circle></shape>
    <initialState>
      <position><point><x>45</x><y>-0.6</y></point></position>
      <orientation><exact>0</exact></orientation>
      <time><exact>0</exact></time>
    </initialState>
  </staticObstacle>
  <staticObstacle id="11">
    <type>unknown</type>
    <shape><polygon>
      <point><x>-3</x><y>1.2</y></point>
      <point><x>3</x><y>1.2</y></point>
      <point><x>0</x><y>-1.2</y></point>
    </polygon></shape>
    <initialState>
      <position><point><x>75</x><y>2.8</y></point></position>
      <orientation><exact>0</exact></orientation>
      <time><exact>0</exact></time>
    </initialState>
  </staticObstacle>
  <planningProblem id="1">
    <initialState>
      <position><point><x>5</x><y>0</y></point></position>
      <velocity><exact>15</exact></velocity>
      <orientation><exact>0</exact></orientation>
      <yawRate><exact>0</exact></yawRate>
      <slipAngle><exact>0</exact></slipAngle>
      <time><exact>0</exact></time>
    </initialState>
    <goalState>
      <position><rectangle><length>12</length><width>8</width>
        <center><x>100</x><y>0</y></center></rectangle></position>
      <time><intervalStart>0</intervalStart><intervalEnd>100</intervalEnd></time>
    </goalState>
  </planningProblem>
</commonRoad>
"""


def _config(tmp_path, fast):
    path = tmp_path / "SYN_Disc-1_1.xml"
    path.write_text(textwrap.dedent(_SCENARIO))
    config = ReactivePlannerConfiguration()
    config.general.path_scenarios = str(tmp_path) + "/"
    config.general.set_path_scenario("SYN_Disc-1_1.xml")
    config.planning.time_steps_computation = 20
    config.sampling.t_min = 0.4
    config.update()
    config.debug.fast_scoring = fast
    if fast:
        config.debug.kernel_dtype = "float32"
    return config


def _drive(tmp_path, fast):
    from tests.test_planner_e2e import _run_loop

    return _run_loop(_config(tmp_path, fast), max_steps=100)


@pytest.mark.parametrize("fast", [False, True],
                         ids=["xla_f64", "pallas_fast"])
def test_circle_obstacle_drive(tmp_path, fast):
    planner = _drive(tmp_path, fast)
    assert planner.goal_reached()

    # the recorded run is collision-free against the EXACT disc
    from commonroad_rp_jax.utils.evaluation import (
        create_full_solution_trajectory, solution_collision_report)

    config = planner.config
    traj = create_full_solution_trajectory(config, planner.record_state_list)
    report = solution_collision_report(config.scenario, traj.state_list,
                                       config.vehicle.length,
                                       config.vehicle.width)
    assert report["collision_free"], report["collision_steps"]
    assert report["boundary_ok"], report["boundary_steps"]

    # ...and the disc genuinely constrained the maneuver: the ego swerves
    # (leaves the lane center) and passes the disc with a small clearance
    # (the exact corner-vs-square divergence itself is unit-pinned in
    # tests/test_collision_shapes.py)
    center = np.array([45.0, -0.6])
    r = 1.8
    hl, hw = 0.5 * config.vehicle.length, 0.5 * config.vehicle.width
    min_clearance = np.inf
    max_lateral = 0.0
    for s in traj.state_list:
        rel = np.asarray(s.position) - center
        c, sn = np.cos(s.orientation), np.sin(s.orientation)
        lx = abs(rel[0] * c + rel[1] * sn)
        ly = abs(-rel[0] * sn + rel[1] * c)
        qx = max(lx - hl, 0.0)
        qy = max(ly - hw, 0.0)
        min_clearance = min(min_clearance, float(np.hypot(qx, qy)) - r)
        max_lateral = max(max_lateral, abs(float(s.position[1])))
    assert min_clearance > 0.0, "must clear the exact disc"
    assert min_clearance < 1.5, "disc did not constrain the maneuver"
    assert max_lateral > 1.0, "expected a swerve around the disc"

    # the triangle jutting into the lane from the left at x=75 forces the
    # ego below its apex (y = 1.6): no recorded pose may reach beyond it
    near_tri = [s for s in traj.state_list if 70 < s.position[0] < 80]
    assert near_tri, "run must pass the triangle's x-span"
    assert max(s.position[1] for s in near_tri) < 1.6


def test_plan_scan_with_shape_obstacles(tmp_path):
    """plan_scan windows the disc AND polygon groups per cycle on device:
    same recorded trajectory as the host fast loop on the shape scenario."""
    from commonroad_rp_jax.utils.route import RoutePlanner

    host = _drive(tmp_path, fast=True)
    assert host.goal_reached()
    want = host.record_state_list

    config = _config(tmp_path, fast=True)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(24)

    assert info["goal_reached"]
    got = planner.record_state_list
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
