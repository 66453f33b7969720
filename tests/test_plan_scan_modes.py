"""plan_scan scope extensions (round 4): exact 'segments' boundary mode,
continuous swept-OBB collision, and planning.factor != 1 — each parity-
checked against the host replanning loop running the same configuration
through the XLA conformance path (reference reactive_planner.py:240-244,
:1032, :1049-1058).

The device scan covers these via the LAZY winner-refinement loop
(parallel/pallas_fleet.py): the fused kernel masks kinematics + discrete
obstacles densely, then the exact segment SAT / swept pass run per WINNER
inside a while_loop — the reference's sorted lazy iteration.
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

pytestmark = pytest.mark.slow


def _make_config(repo_root, scenario="ZAM_Over-1_1", **planning_overrides):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / f"{scenario}.yaml", f"{scenario}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{scenario}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    for key, value in planning_overrides.items():
        setattr(config.planning, key, value)
    return config


def _scan_planner(config):
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    return planner


def _compare(host, scan_planner, info, max_states=None):
    want = host.record_state_list
    got = scan_planner.record_state_list
    n = min(len(want), len(got)) if max_states is None \
        else min(len(want), len(got), max_states)
    assert n > 6, (len(want), len(got))
    for a, b in zip(want[:n], got[:n]):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)


def test_plan_scan_segments_matches_host(repo_root):
    """Exact road-boundary SAT ('segments') through plan_scan: the lazy
    refinement must reproduce the host loop's trajectory (which runs the
    dense XLA segment check — reference boundary obstacle semantics)."""
    from tests.test_planner_e2e import _run_loop

    host = _run_loop(_make_config(repo_root, boundary_mode="segments"))
    assert host.goal_reached()

    config = _make_config(repo_root, boundary_mode="segments")
    planner = _scan_planner(config)
    info = planner.plan_scan(14)
    assert info["goal_reached"]
    _compare(host, planner, info)


def test_plan_scan_continuous_matches_host(repo_root):
    """Continuous (swept-OBB) collision through plan_scan vs the host loop
    with continuous_collision_check: True (reference :240-244, :1049-58)."""
    from tests.test_planner_e2e import _run_loop

    host = _run_loop(_make_config(repo_root,
                                  continuous_collision_check=True))
    assert host.goal_reached()

    config = _make_config(repo_root, continuous_collision_check=True)
    planner = _scan_planner(config)
    info = planner.plan_scan(14)
    assert info["goal_reached"]
    _compare(host, planner, info)


def test_plan_scan_factor2_matches_host(repo_root):
    """planning.factor = 2 through plan_scan: obstacle tables sampled at
    stride 2, recorded scenario steps advance 2 per planned step
    (reference :1032) — parity with the host loop on the dynamic-obstacle
    scenario where the stride is observable."""
    from tests.test_planner_e2e import _run_loop

    host = _run_loop(_make_config(repo_root, scenario="DEU_Test-1_1_T-1",
                                  factor=2), max_steps=24)
    config = _make_config(repo_root, scenario="DEU_Test-1_1_T-1", factor=2)
    planner = _scan_planner(config)
    info = planner.plan_scan(8, stop_on_goal=False)
    assert info["cycles_run"] >= 6
    # recorded scenario steps advance by factor per planned step
    steps = [s.time_step for s in planner.record_state_list]
    assert steps[:4] == [0, 2, 4, 6]
    _compare(host, planner, info, max_states=22)


def _plan_once(repo_root, fast, **planning_overrides):
    config = _make_config(repo_root, **planning_overrides)
    config.debug.fast_scoring = fast
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    return result, planner


def test_fast_plan_segments_matches_xla(repo_root):
    """plan() with boundary_mode='segments' now runs the fused kernel +
    lazy segment refinement; the selected trajectory must match the XLA
    dense path."""
    xla, _ = _plan_once(repo_root, fast=False, boundary_mode="segments")
    fast, planner = _plan_once(repo_root, fast=True,
                               boundary_mode="segments")
    np.testing.assert_allclose(
        np.stack([s.position for s in fast[0].state_list]),
        np.stack([s.position for s in xla[0].state_list]), atol=1e-4)


def test_fast_plan_continuous_matches_xla(repo_root):
    """plan() with continuous_collision_check now runs the fused kernel +
    lazy swept-OBB refinement; trajectory parity with the XLA dense path."""
    xla, _ = _plan_once(repo_root, fast=False,
                        continuous_collision_check=True)
    fast, planner = _plan_once(repo_root, fast=True,
                               continuous_collision_check=True)
    np.testing.assert_allclose(
        np.stack([s.position for s in fast[0].state_list]),
        np.stack([s.position for s in xla[0].state_list]), atol=1e-4)
    assert planner.infeasible_count_collision == \
        _plan_once(repo_root, fast=False,
                   continuous_collision_check=True)[1] \
        .infeasible_count_collision
