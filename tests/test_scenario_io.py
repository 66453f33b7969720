"""Scenario XML reader against the four bundled CommonRoad scenarios.

Census counted directly from the bundled XML files (note: SURVEY.md section 2.1
quotes different dynamic-obstacle counts; the XML files are ground truth).
"""

import numpy as np
import pytest

from commonroad_rp_jax.utils.scenario import Interval, read_scenario_xml


CENSUS = {
    "ZAM_Over-1_1.xml": dict(static=1, dynamic=0, lanelets=2),
    "DEU_Test-1_1_T-1.xml": dict(static=1, dynamic=1, lanelets=4),
    "ZAM_Tjunction-1_42_T-1.xml": dict(static=0, dynamic=5, lanelets=12),
    "ZAM-Ramp-1_1-T-1.xml": dict(static=0, dynamic=3, lanelets=11),
}


@pytest.mark.parametrize("filename", sorted(CENSUS))
def test_census(scenario_dir, filename):
    scenario, pp_set = read_scenario_xml(scenario_dir / filename)
    expected = CENSUS[filename]
    assert len(scenario.static_obstacles) == expected["static"]
    assert len(scenario.dynamic_obstacles) == expected["dynamic"]
    assert len(scenario.lanelet_network.lanelets) == expected["lanelets"]
    assert scenario.dt == 0.1
    assert len(pp_set.planning_problem_dict) >= 1


def test_zam_over_details(scenario_dir):
    scenario, pp_set = read_scenario_xml(scenario_dir / "ZAM_Over-1_1.xml")
    obstacle = scenario.static_obstacles[0]
    assert obstacle.obstacle_id == 1402
    np.testing.assert_allclose(obstacle.initial_state.position, [59.948, 0.48323])
    assert obstacle.shape.length == 6.0 and obstacle.shape.width == 3.5

    pp = pp_set.find_planning_problem_by_id(1)
    np.testing.assert_allclose(pp.initial_state.position, [29.9948, -1.1501])
    assert pp.initial_state.velocity == 20.0
    goal = pp.goal.state_list[0]
    assert len(goal.position_shapes) == 1
    rect = goal.position_shapes[0]
    np.testing.assert_allclose(rect.center, [87.8, 3.3])
    assert goal.time_step == Interval(0, 30)


def test_dynamic_obstacle_trajectory(scenario_dir):
    scenario, _ = read_scenario_xml(scenario_dir / "DEU_Test-1_1_T-1.xml")
    obs = scenario.dynamic_obstacles[0]
    assert obs.obstacle_id == 6
    assert obs.initial_state.velocity == 10.0
    assert len(obs.trajectory) > 10
    state_1 = obs.state_at_time(1)
    np.testing.assert_allclose(state_1.position, [18.0, 2.0])
    assert obs.state_at_time(10_000) is None


def test_lanelet_topology_and_polygon(scenario_dir):
    scenario, _ = read_scenario_xml(scenario_dir / "ZAM_Tjunction-1_42_T-1.xml")
    net = scenario.lanelet_network
    some = [l for l in net.lanelets if l.successors]
    assert some, "expected successor topology in T-junction scenario"
    lanelet = net.lanelets[0]
    center = lanelet.center_vertices
    # each center vertex lies inside the lanelet polygon
    mid = center[len(center) // 2]
    assert lanelet.contains_point(mid)
    found = net.find_lanelet_by_position(mid)
    assert lanelet.lanelet_id in found


def test_goal_lanelet_reached(scenario_dir):
    scenario, pp_set = read_scenario_xml(scenario_dir / "DEU_Test-1_1_T-1.xml")
    pp = list(pp_set.planning_problem_dict.values())[0]
    goal = pp.goal
    lanelet = scenario.lanelet_network.find_lanelet_by_id(goal.state_list[0].position_lanelets[0])
    from commonroad_rp_jax.models.state import TraceState
    mid = lanelet.center_vertices[len(lanelet.center_vertices) // 2]
    inside = TraceState(time_step=37, position=mid, velocity=5.0, orientation=0.0)
    assert goal.is_reached(inside)
    too_early = TraceState(time_step=3, position=mid, velocity=5.0, orientation=0.0)
    assert not goal.is_reached(too_early)
