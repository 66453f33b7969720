"""Stopping mode: quintic longitudinal sampling toward a stop position.

Exercises the reference's second longitudinal driving mode
(sampling.py:259-263 quintic generation, reactive_planner.py:349-376
set_desired_lon_position, trajectories.py:545-550 filter_goals_behind,
cost_function.py:60-62 stopping cost with w_a = 1).
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(scope="module")
def stopping_planner(repo_root):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.sampling.longitudinal_mode = "stopping"
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    # stopping from 20 m/s within the 2 s horizon violates a_max (quintic peak
    # deceleration ~1.88 dv/T); start at a stop-approach speed instead
    slow_x0 = planner.x_0.copy()
    slow_x0.velocity = 8.0
    slow_x0.yaw_rate = 0.0
    planner.reset(initial_state_cart=slow_x0,
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)
    return planner


def test_stop_position_tracking(stopping_planner):
    planner = stopping_planner
    s0 = planner.x_0_cl[0][0]
    stop_s = s0 + 8.0          # ~ natural stopping distance v0*T/2
    planner.set_desired_lon_position(stop_s)
    assert planner.cost_function.w_a == 1          # reactive_planner.py:376
    assert planner.cost_function.desired_speed == 0.0

    result = planner.plan()
    assert result is not None
    cart, cl, lon_list, lat_list = result
    # trajectory decelerates toward the stop point
    velocities = [s.velocity for s in cart.state_list]
    assert velocities[-1] < velocities[0]
    # longitudinal end position moves toward (not beyond) the stop point
    assert lon_list[-1][0] <= stop_s + 2.0
    assert lon_list[-1][0] > s0


def test_filter_goals_behind(stopping_planner):
    """Stop targets behind the current position are filtered out: with all
    targets behind, planning falls back (no feasible candidate from grids)."""
    planner = stopping_planner
    s0 = planner.x_0_cl[0][0]
    planner.set_desired_lon_position(s0 - 50.0)     # all samples behind
    result = planner.plan()
    # every candidate is goal-filtered; the planner cannot find a trajectory
    # (vehicle is moving at 20 m/s so no standstill fallback either)
    assert result is None


def test_stopping_full_loop(repo_root):
    """Replan in stopping mode until the vehicle halts near the stop point."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.sampling.longitudinal_mode = "stopping"
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    slow_x0 = planner.x_0.copy()
    slow_x0.velocity = 8.0
    slow_x0.yaw_rate = 0.0
    planner.reset(initial_state_cart=slow_x0,
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)
    planner.record_state_and_input(planner.x_0)

    stop_s = planner.x_0_cl[0][0] + 8.0
    optimal = None
    for _ in range(120):
        count = len(planner.record_state_list) - 1
        freq = config.planning.replanning_frequency
        if count % freq == 0:
            planner.set_desired_lon_position(stop_s)
            new = planner.plan()
            if new is None:
                break
            optimal = new
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
        if planner.x_0.velocity <= 0.05:
            break

    final_s = planner.x_0_cl[0][0]
    final_v = planner.x_0.velocity
    assert final_v < 2.0, f"vehicle should be nearly stopped, v={final_v}"
    assert abs(final_s - stop_s) < 5.0, \
        f"vehicle stopped at s={final_s:.1f}, target {stop_s:.1f}"


def test_stopping_fast_path_matches_xla(repo_root):
    """Fast path in STOPPING mode (quintic lon targets, stopping cost with
    w_a = 1, goal-behind filtering): same selection and counters as the XLA
    path through the fused union-level dispatch."""
    def plan(fast):
        config = ReactivePlannerConfiguration.load(
            repo_root / "configurations" / "ZAM_Over-1_1.yaml",
            "ZAM_Over-1_1.xml")
        config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
        config.general.set_path_scenario("ZAM_Over-1_1.xml")
        config.update()
        config.sampling.longitudinal_mode = "stopping"
        config.debug.kernel_dtype = "float32"
        config.debug.fast_scoring = fast
        route = RoutePlanner(config.scenario,
                             config.planning_problem).plan_routes() \
            .retrieve_first_route()
        planner = ReactivePlanner(config)
        planner.set_reference_path(route.reference_path)
        slow_x0 = planner.x_0.copy()
        slow_x0.velocity = 8.0
        slow_x0.yaw_rate = 0.0
        planner.reset(initial_state_cart=slow_x0,
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
        planner.set_desired_lon_position(planner.x_0_cl[0][0] + 8.0)
        return planner, planner.plan()

    ref_planner, want = plan(False)
    fast_planner, got = plan(True)
    assert want is not None and got is not None
    for a, b in zip(want[0].state_list, got[0].state_list):
        np.testing.assert_allclose(b.position, a.position, atol=1e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=1e-3)
    assert fast_planner.infeasible_count_kinematics == \
        ref_planner.infeasible_count_kinematics
    assert fast_planner.infeasible_count_collision == \
        ref_planner.infeasible_count_collision
    assert fast_planner.infeasible_reason_dict == \
        ref_planner.infeasible_reason_dict
