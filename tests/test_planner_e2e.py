"""End-to-end: full cyclic replanning on the bundled scenarios (CPU).

Mirrors the reference driver loop (run_planner.py:61-107): plan every
``replanning_frequency`` steps, step along the previous optimum in between,
reset with carried-over collision checker and coordinate system.
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


def _run_loop(config, max_steps=150):
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.record_state_and_input(planner.x_0)
    optimal = None
    while not planner.goal_reached() and len(planner.record_state_list) <= max_steps:
        count = len(planner.record_state_list) - 1
        freq = config.planning.replanning_frequency
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            if not optimal:
                break
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    return planner


@pytest.fixture(scope="module")
def over_planner(repo_root):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    return _run_loop(config)


def test_over_reaches_goal(over_planner):
    assert over_planner.goal_reached()
    assert len(over_planner.record_state_list) < 60


def test_over_avoids_obstacle(over_planner):
    """The selected maneuver must clear the static obstacle: when the ego is
    longitudinally inside the obstacle span, its lateral gap must exceed the
    half widths."""
    wb = over_planner.vehicle_params.wb_rear_axle
    obstacle = np.array([59.948, 0.48323])
    for state in over_planner.record_state_list:
        center = state.position + wb * np.array([np.cos(state.orientation),
                                                 np.sin(state.orientation)])
        if abs(center[0] - obstacle[0]) < 3.0:          # inside obstacle x-span
            assert center[1] - obstacle[1] > 0.5 * 3.5, \
                f"ego at {center} not clear of obstacle"


def test_over_is_dynamically_smooth(over_planner):
    """Recorded velocities/accelerations stay within vehicle limits."""
    v = np.array([s.velocity for s in over_planner.record_state_list])
    a = np.array([s.acceleration for s in over_planner.record_state_list])
    assert np.all(v >= -1e-5)
    assert np.all(np.abs(a) <= over_planner.vehicle_params.a_max + 1e-6)
    # velocity consistency: |dv/dt| bounded by a_max between steps
    dv = np.abs(np.diff(v)) / over_planner.dt
    assert np.percentile(dv, 95) <= over_planner.vehicle_params.a_max + 1e-6


def test_deu_dynamic_obstacles(repo_root):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "DEU_Test-1_1_T-1.yaml",
        "DEU_Test-1_1_T-1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("DEU_Test-1_1_T-1.xml")
    config.update()
    planner = _run_loop(config)
    assert planner.goal_reached()


@pytest.fixture(scope="module")
def tjunction_planner(repo_root):
    """T-junction with 10 dynamic obstacles on the f64 XLA conformance path
    (the hardest scenario: yield to crossing traffic, then turn)."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Tjunction-1_42_T-1.yaml",
        "ZAM_Tjunction-1_42_T-1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Tjunction-1_42_T-1.xml")
    config.update()
    return _run_loop(config, max_steps=200)


def test_tjunction_reaches_goal_xla(tjunction_planner):
    assert tjunction_planner.goal_reached()
    # pinned full-run golden: 146 driven steps (+ the initial state), the
    # same count the fast-scoring path records (tests/test_fast_scoring.py)
    assert len(tjunction_planner.record_state_list) == 147


def test_tjunction_yields_to_traffic(tjunction_planner):
    """The recorded run must be collision-free against all 10 dynamic
    obstacles and stay on the road (exact per-step solution check)."""
    from commonroad_rp_jax.utils.evaluation import (
        create_full_solution_trajectory, solution_collision_report)

    config = tjunction_planner.config
    traj = create_full_solution_trajectory(
        config, tjunction_planner.record_state_list)
    report = solution_collision_report(
        config.scenario, traj.state_list,
        config.vehicle.length, config.vehicle.width)
    assert report["collision_free"], report["collision_steps"]
    assert report["boundary_ok"], report["boundary_steps"]


def test_ramp_reaches_goal_xla(repo_root):
    """Standstill start (v=0: low-velocity mode + standstill fallback) on
    the f64 XLA conformance path."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM-Ramp-1_1-T-1.yaml",
        "ZAM-Ramp-1_1-T-1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM-Ramp-1_1-T-1.xml")
    config.update()
    planner = _run_loop(config, max_steps=100)
    assert planner.goal_reached()
    # pinned full-run golden: 44 driven steps + the initial state
    # (one more step since the CLCS front extension starts the drive from
    # the true rear-axle position 1.42 m behind the route start instead of
    # teleporting to s = 0 — tests/test_precision_and_golden.py)
    assert len(planner.record_state_list) == 45


# ---------------------------------------------------------------------------
# solution-level validation (commonroad-dc solution_checker parity)
# ---------------------------------------------------------------------------

def test_valid_solution_over(over_planner):
    """The recorded ZAM_Over run passes the full validity check, including
    the ego-obstacle collision and road-boundary stages (reference:
    utility/evaluation.py:71 via commonroad-dc's solution checker)."""
    from commonroad_rp_jax.utils.evaluation import (
        create_full_solution_trajectory, create_planning_problem_solution,
        valid_solution)

    config = over_planner.config
    traj = create_full_solution_trajectory(config,
                                           over_planner.record_state_list)
    solution = create_planning_problem_solution(
        config, traj, config.scenario, config.planning_problem)
    ok, detail = valid_solution(config.scenario,
                                config.planning_problem_set, solution)
    assert ok, detail
    d = detail[config.planning_problem.planning_problem_id]
    assert d["collision_free"] and d["boundary_ok"]


def test_valid_solution_detects_collision(over_planner):
    """A deliberately colliding solution (driving straight through the
    parked obstacle at (59.9, 0.48)) must FAIL validation with the
    colliding time steps reported — round 1 validated such a solution."""
    from commonroad_rp_jax.models.state import ReactivePlannerState
    from commonroad_rp_jax.models.trajectories import Trajectory
    from commonroad_rp_jax.utils.evaluation import (
        create_planning_problem_solution, valid_solution)

    config = over_planner.config
    x0 = config.planning_problem.initial_state
    v = x0.velocity
    dt = config.planning.dt
    states = [ReactivePlannerState(
        time_step=i, position=x0.position + np.array([v * dt * i, 0.0]),
        velocity=v, orientation=0.0, steering_angle=0.0, acceleration=0.0)
        for i in range(60)]
    solution = create_planning_problem_solution(
        config, Trajectory(0, states), config.scenario,
        config.planning_problem)
    ok, detail = valid_solution(config.scenario,
                                config.planning_problem_set, solution)
    assert not ok
    d = detail[config.planning_problem.planning_problem_id]
    assert not d["collision_free"]
    assert len(d["collision_steps"]) > 0


def test_route_planner_all_scenarios(repo_root):
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    for name in ["ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM_Tjunction-1_42_T-1",
                 "ZAM-Ramp-1_1-T-1"]:
        scenario, pp, _ = load_scenario_and_planning_problem(
            str(repo_root / "example_scenarios" / f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        ref = route.reference_path
        assert len(ref) > 10
        # the reference path passes near the initial position
        d = np.min(np.linalg.norm(ref - pp.initial_state.position, axis=1))
        assert d < 5.0, f"{name}: reference path {d:.1f} m from initial state"


def test_default_long_horizon(repo_root):
    """The default 6 s horizon (N=60, T=61) plans a full cycle."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.planning.time_steps_computation = 60      # config.py:114 default
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    assert len(result[0].state_list) == 61


def test_factor_time_scaling(repo_root):
    """planning.factor scales ego steps to scenario steps for dynamic
    obstacles (reactive_planner.py:1040) and output time stamps (:531)."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "DEU_Test-1_1_T-1.yaml",
        "DEU_Test-1_1_T-1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("DEU_Test-1_1_T-1.xml")
    config.update()
    config.planning.factor = 2
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    steps = [s.time_step for s in result[0].state_list]
    assert steps[1] - steps[0] == 2                  # scaled time stamps
