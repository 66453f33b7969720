"""Precision-consistency and golden-trajectory regression tests.

- float32 vs float64 selection agreement on a full level evaluation
  (SURVEY.md section 7 hard part 2: selection across precisions).
- Golden regression: the selected candidate and its cost on the first
  ZAM_Over planning cycle, pinned against drift.
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


def _planner(repo_root, dtype):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.debug.kernel_dtype = dtype
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return planner


def test_f32_selection_matches_f64(repo_root):
    """The f32 path must pick the same candidate as the f64 conformance path
    on the first ZAM_Over cycle (costs are well separated there)."""
    p64 = _planner(repo_root, "float64")
    p32 = _planner(repo_root, "float32")
    r64 = p64.plan()
    r32 = p32.plan()
    assert r64 is not None and r32 is not None
    np.testing.assert_allclose(p32.optimal_cost, p64.optimal_cost, rtol=1e-4)
    # selected trajectories agree to f32 resolution
    for s64, s32 in zip(r64[0].state_list, r32[0].state_list):
        np.testing.assert_allclose(s32.position, s64.position, atol=5e-3)
        np.testing.assert_allclose(s32.velocity, s64.velocity, atol=5e-3)
    assert p32.infeasible_count_kinematics == p64.infeasible_count_kinematics


# ---------------------------------------------------------------------------
# pinned first-cycle goldens (all 4 scenarios, f64 conformance path)
# ---------------------------------------------------------------------------

# Literal constants recorded 2026-08-18 from the f64 XLA conformance path on
# CPU (oracle-validated, tests/test_kinematics_conformance.py).  Any semantic
# regression in grid generation, rollout, cost, constraint order, or
# collision changes one of these values — unlike a same-run determinism
# check, these cannot drift silently.
_GOLDEN_FIRST_CYCLE = {
    "ZAM_Over-1_1": dict(
        cost=3733.4777003862982,
        end_position=(67.81315751831903, 4.149639636126384),
        end_velocity=19.508531368656065,
        end_orientation=0.08752291224665676,
        infeasible_kinematics=45, infeasible_collision=44,
        reason_dict={"acceleration": 2, "kappa_dot": 43}),
    "DEU_Test-1_1_T-1": dict(
        cost=79.28082121119598,
        end_position=(57.224441656399875, 2.0000000000000067),
        end_velocity=11.606224999999998,
        end_orientation=3.297691703707007e-16,
        infeasible_kinematics=76, infeasible_collision=0,
        reason_dict={"acceleration": 18, "kappa_dot": 52, "yaw_rate": 6}),
    # end_position re-pinned 2026-08-19: the CLCS front extension
    # (geometry.extend_ref_path_front) lets the rear-axle x0 before the
    # route start project properly instead of clamping to s = 0, so the
    # first cycle starts 1.42 m (wb_rear_axle) further back — selection,
    # cost, and counters are unchanged
    "ZAM-Ramp-1_1-T-1": dict(
        cost=305733.87850203505,
        end_position=(6.327282906400004, 1.7499999999999991),
        end_velocity=5.000000000000005,
        end_orientation=6.86410096761853e-17,
        infeasible_kinematics=68, infeasible_collision=0,
        reason_dict={"acceleration": 12, "kappa": 12, "kappa_dot": 44}),
    "ZAM_Tjunction-1_42_T-1": dict(
        cost=43.12236764498027,
        end_position=(-0.6221825578422608, 0.021638369718770756),
        end_velocity=5.240995600000005,
        end_orientation=-0.03976196117155634,
        infeasible_kinematics=63, infeasible_collision=0,
        reason_dict={"kappa_dot": 63}),
}


def _planner_for(repo_root, name, dtype):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / f"{name}.yaml", f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    config.debug.kernel_dtype = dtype
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return planner


@pytest.mark.parametrize("name", sorted(_GOLDEN_FIRST_CYCLE))
def test_golden_first_cycle(repo_root, name):
    """Pin the first planning cycle of every bundled scenario against the
    hard-coded f64 goldens (winner cost, end state, rejection counters, and
    the per-constraint reason histogram)."""
    golden = _GOLDEN_FIRST_CYCLE[name]
    planner = _planner_for(repo_root, name, "float64")
    result = planner.plan()
    assert result is not None
    cart = result[0].state_list

    assert len(cart) == planner.N + 1
    np.testing.assert_allclose(planner.optimal_cost, golden["cost"],
                               rtol=1e-9)
    np.testing.assert_allclose(cart[-1].position, golden["end_position"],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(cart[-1].velocity, golden["end_velocity"],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(cart[-1].orientation,
                               golden["end_orientation"], rtol=0, atol=1e-9)
    assert planner.infeasible_count_kinematics == golden["infeasible_kinematics"]
    assert planner.infeasible_count_collision == golden["infeasible_collision"]
    got_reasons = {k: v for k, v in planner.infeasible_reason_dict.items() if v}
    assert got_reasons == golden["reason_dict"]
