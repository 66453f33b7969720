"""Visualization smoke tests (Agg backend, no display)."""

import logging
import os

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner
from commonroad_rp_jax.utils import visualization as viz

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(scope="module")
def planned(repo_root):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.debug.draw_traj_set = True
    config.debug.save_plots = True
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    return config, planner, result


def test_scenario_plot(planned, tmp_path):
    config, planner, _ = planned
    path = str(tmp_path / "scenario.png")
    viz.visualize_scenario_and_pp(config.scenario, config.planning_problem,
                                  cosy=planner.coordinate_system, save_path=path)
    assert os.path.getsize(path) > 10_000


def test_timestep_plot_with_bundle(planned, tmp_path):
    config, planner, result = planned
    assert planner.stored_trajectories is not None, \
        "draw_traj_set should populate the stored bundle"
    ego = planner.convert_state_list_to_commonroad_object(result[0].state_list)
    path = str(tmp_path / "step.png")
    viz.visualize_planner_at_timestep(
        config.scenario, config.planning_problem, ego, timestep=0,
        config=config, traj_set=planner.stored_trajectories,
        ref_path=planner.reference_path, save_path=path)
    assert os.path.getsize(path) > 10_000


def test_final_trajectory_plot(planned, tmp_path):
    config, planner, result = planned
    path = str(tmp_path / "final.png")
    viz.plot_final_trajectory(config.scenario, config.planning_problem,
                              result[0].state_list, config, save_path=path)
    assert os.path.getsize(path) > 10_000


def test_bundle_labels(planned):
    _, planner, _ = planned
    bundle = planner.stored_trajectories
    from commonroad_rp_jax.models.trajectories import FeasibilityStatus
    labels = set(bundle.labels)
    assert FeasibilityStatus.FEASIBLE in labels
    assert len(bundle.labels) == len(bundle.costs)


def test_visualize_collision_checker_and_projection_domain(repo_root, tmp_path):
    from commonroad_rp_jax.utils.coordinate_system import CoordinateSystem
    from commonroad_rp_jax.utils.route import RoutePlanner
    from commonroad_rp_jax.utils.visualization import (
        visualize_collision_checker, visualize_scenario_and_pp)

    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Tjunction-1_42_T-1.xml"))
    out = tmp_path / "cc.png"
    visualize_collision_checker(scenario, timestep=0, save_path=str(out))
    assert out.stat().st_size > 1000

    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    cosy = CoordinateSystem(route.reference_path)
    domain = cosy.projection_domain()
    assert domain.shape[1] == 2 and domain.shape[0] > 10
    assert np.isfinite(domain).all()
    # closed polygon
    np.testing.assert_allclose(domain[0], domain[-1])
    out2 = tmp_path / "pp.png"
    visualize_scenario_and_pp(scenario, pp, cosy=cosy, save_path=str(out2))
    assert out2.stat().st_size > 1000
