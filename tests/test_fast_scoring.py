"""Facade fast-scoring path (config.debug.fast_scoring): the fused
scorer behind the ReactivePlanner API.

Runs the full ZAM_Over replanning loop with fast scoring on the CPU and
checks it against the XLA conformance path: goal reached, matching
selected trajectories, and exact rejection counters.  The per-constraint
reason dict is documented as lost on this path (the reference's
multiprocessing mode loses it the same way, reactive_planner.py:962-967).
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


def _make_config(repo_root, fast):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.debug.fast_scoring = fast
    # fast path runs float32; compare against the float32 XLA path so any
    # difference is the scoring backend, not the dtype
    config.debug.kernel_dtype = "float32"
    return config


def _plan_once(repo_root, fast):
    config = _make_config(repo_root, fast)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    return planner, result


@pytest.fixture(scope="module")
def both_paths(repo_root):
    return _plan_once(repo_root, fast=False), _plan_once(repo_root, fast=True)


def test_fast_scoring_selects_same_trajectory(both_paths):
    (_, want), (_, got) = both_paths
    assert want is not None and got is not None
    want_cart, got_cart = want[0], got[0]
    assert len(want_cart.state_list) == len(got_cart.state_list)
    for a, b in zip(want_cart.state_list, got_cart.state_list):
        np.testing.assert_allclose(b.position, a.position, atol=1e-4)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=1e-4)


def test_fast_scoring_counters_match(both_paths):
    (ref_planner, _), (fast_planner, _) = both_paths
    assert fast_planner.infeasible_count_kinematics == \
        ref_planner.infeasible_count_kinematics
    assert fast_planner.infeasible_count_collision == \
        ref_planner.infeasible_count_collision
    assert fast_planner.optimal_cost == pytest.approx(
        ref_planner.optimal_cost, rel=1e-5)


def test_fast_scoring_reason_dict_matches_xla(both_paths):
    """The kernel's first-failure reason row reconstructs the per-constraint
    reason dict exactly (the reference LOSES it in multiprocessing mode,
    reactive_planner.py:962-967 — this path beats that)."""
    (ref_planner, _), (fast_planner, _) = both_paths
    want = ref_planner.infeasible_reason_dict
    got = fast_planner.infeasible_reason_dict
    assert got == want
    assert sum(got.values()) > 0, "degenerate: nothing rejected"


def test_fast_scoring_full_loop_reaches_goal(repo_root):
    from tests.test_planner_e2e import _run_loop

    config = _make_config(repo_root, fast=True)
    planner = _run_loop(config)
    assert planner.goal_reached()
    assert len(planner.record_state_list) < 60


@pytest.mark.parametrize("scenario,max_len", [
    ("ZAM-Ramp-1_1-T-1", 60),          # standstill start, low-velocity mode
    ("ZAM_Tjunction-1_42_T-1", 160),   # 10 dynamic obstacles, yield phase
])
def test_fast_scoring_hard_scenarios_reach_goal(repo_root, scenario, max_len):
    """The fast path drives the standstill-fallback and dense-traffic
    scenarios end to end with the same step counts as the XLA path."""
    from tests.test_planner_e2e import _run_loop

    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / f"{scenario}.yaml", f"{scenario}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{scenario}.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    planner = _run_loop(config, max_steps=max_len)
    assert planner.goal_reached()


def test_fast_scoring_dynamic_obstacles(repo_root):
    """Dynamic-obstacle scenario (DEU_Test, 2 moving vehicles): the fast
    path must agree with the XLA path on selection and counters when the
    obstacle occupancy window is time-variant."""
    def plan(fast):
        config = ReactivePlannerConfiguration.load(
            repo_root / "configurations" / "DEU_Test-1_1_T-1.yaml",
            "DEU_Test-1_1_T-1.xml")
        config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
        config.general.set_path_scenario("DEU_Test-1_1_T-1.xml")
        config.update()
        config.debug.fast_scoring = fast
        config.debug.kernel_dtype = "float32"
        route = RoutePlanner(config.scenario,
                             config.planning_problem).plan_routes() \
            .retrieve_first_route()
        planner = ReactivePlanner(config)
        planner.set_reference_path(route.reference_path)
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        return planner, planner.plan()

    ref_planner, want = plan(False)
    fast_planner, got = plan(True)
    assert want is not None and got is not None
    for a, b in zip(want[0].state_list, got[0].state_list):
        np.testing.assert_allclose(b.position, a.position, atol=1e-4)
    assert fast_planner.infeasible_count_kinematics == \
        ref_planner.infeasible_count_kinematics
    assert fast_planner.infeasible_count_collision == \
        ref_planner.infeasible_count_collision


def test_fast_scoring_no_feasible_candidates_returns_none(repo_root):
    """When every candidate is rejected (drivable band squeezed to a
    sliver), the fast path must return None from the level evaluation and
    plan() must degrade exactly like the XLA path (standstill fallback only
    at v~0, else None + warning)."""
    import jax.numpy as jnp

    from commonroad_rp_jax.ops.collision import CorridorArrays

    config = _make_config(repo_root, fast=True)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    # squeeze the cached corridor band to an impossible sliver
    corr = planner.collision_checker.corridor_for(planner.coordinate_system)
    planner.collision_checker._corridor_cache[planner.coordinate_system] = \
        CorridorArrays(d_lo=jnp.full_like(corr.d_lo, 0.001),
                       d_hi=jnp.full_like(corr.d_hi, 0.002))
    result = planner.plan()
    assert result is None
    assert planner.infeasible_count_collision > 0


def test_fused_levels_escalation_unit():
    """evaluate_levels_fast: when level 0 has no collision-free candidate,
    the winner and statistics must come from level 1 — identical to running
    the levels sequentially (reference escalation, reactive_planner.py:616)."""
    import jax
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import collision as co
    from commonroad_rp_jax.ops import cycle as cycle_ops
    from commonroad_rp_jax.ops import frenet as frenet_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.ops.polynomial import quartic_coeffs, quintic_coeffs

    with jax.enable_x64(False):
        dtype = jnp.float32
        n = 200
        s_ref = np.linspace(0.0, 120.0, n)
        ref = frenet_ops.RefPathTables(
            points=jnp.asarray(np.stack([s_ref, np.zeros(n)], 1), dtype),
            s=jnp.asarray(s_ref, dtype), theta=jnp.zeros(n, dtype),
            curv=jnp.zeros(n, dtype), curv_d=jnp.zeros(n, dtype),
            curv_dd=jnp.zeros(n, dtype),
            tangent=jnp.asarray(np.tile([1.0, 0.0], (n, 1)), dtype),
            normal=jnp.asarray(np.tile([0.0, 1.0], (n, 1)), dtype))
        veh = kin_ops.VehicleArrays(
            wheelbase=dtype(2.5), wb_rear_axle=dtype(1.4), a_max=dtype(8.0),
            v_switch=dtype(7.3), kappa_max=dtype(0.2), v_delta_max=dtype(0.4),
            half_length=dtype(2.2), half_width=dtype(0.9))
        n_steps, dt = 20, 0.1
        horizon = n_steps * dt

        def lat_fan(d_ends):
            K = len(d_ends)
            x0 = np.zeros((K, 3))
            xd = np.stack([d_ends, np.zeros(K), np.zeros(K)], 1)
            return np.asarray(quintic_coeffs(jnp.asarray(x0), jnp.asarray(xd),
                                             jnp.full(K, horizon)))

        # wall ahead (x in [14, 20], |d| <= 0.5): level 0 samples only
        # d in [-0.5, 0.5] (every candidate collides), level 1 adds the
        # kinematically feasible escapes d = +-2.0
        d0 = np.linspace(-0.5, 0.5, 5)
        d1 = np.concatenate([np.linspace(-0.5, 0.5, 5), [-2.0, 2.0]])
        lon1 = np.asarray(quartic_coeffs(jnp.asarray([[0.0, 10.0, 0.0]]),
                                         jnp.asarray([10.0]),
                                         jnp.asarray([horizon])))
        c_lat = np.concatenate([lat_fan(d0), lat_fan(d1)])
        K = len(c_lat)
        c_lon = np.tile(lon1, (K, 1))
        traj_len = jnp.full((K,), n_steps + 1, jnp.int32)
        level_ids = np.concatenate([np.zeros(len(d0), np.int32),
                                    np.ones(len(d1), np.int32)])

        obstacles = co.ObstacleArrays(
            pose=jnp.asarray(np.tile([17.0, 0.0, 0.0], (1, n_steps + 1, 1)),
                             dtype),
            half_ext=jnp.asarray([[3.0, 0.5]], dtype),
            valid=jnp.ones((1, n_steps + 1), dtype=bool))
        corridor = co.CorridorArrays(d_lo=jnp.full((n,), -1e9, dtype),
                                     d_hi=jnp.full((n,), 1e9, dtype))
        cost_params = cycle_ops.CostParams(
            w_a=dtype(5.0), desired_d=dtype(0.0), desired_speed=dtype(10.0),
            desired_s=dtype(0.0))
        kwargs = dict(dt=dt, n_steps=n_steps, low_vel_mode=False,
                      cost_structure=("default", True, False),
                      constraint_flags=(True,) * 5)

        fused = cycle_ops.evaluate_levels_fast(
            jnp.asarray(c_lon, dtype), jnp.asarray(c_lat, dtype), traj_len,
            jnp.ones(K, dtype=bool), jnp.asarray(level_ids), ref, veh,
            obstacles, corridor, dtype(0.0), cost_params, n_levels=2,
            **kwargs)
        scalars = np.asarray(fused.scalars)
        assert bool(np.asarray(fused.found))
        assert int(scalars[5]) == 1                       # escalated to level 1

        # sequential reference: level 1's slice alone
        sl = slice(len(d0), K)
        single = cycle_ops.evaluate_level_fast(
            jnp.asarray(c_lon[sl], dtype), jnp.asarray(c_lat[sl], dtype),
            traj_len[sl], jnp.ones(len(d1), dtype=bool), ref, veh,
            obstacles, corridor, dtype(0.0), cost_params, **kwargs)
        s_single = np.asarray(single.scalars)
        assert int(scalars[0]) - len(d0) == int(s_single[0])  # same winner
        assert scalars[1] == s_single[1]                      # same cost
        assert scalars[2] == s_single[2] and scalars[3] == s_single[3]

        # level 0 alone finds nothing (the escalation premise)
        lvl0 = cycle_ops.evaluate_level_fast(
            jnp.asarray(c_lon[:len(d0)], dtype),
            jnp.asarray(c_lat[:len(d0)], dtype), traj_len[:len(d0)],
            jnp.ones(len(d0), dtype=bool), ref, veh, obstacles, corridor,
            dtype(0.0), cost_params, **kwargs)
        assert not bool(np.asarray(lvl0.found))


def test_plan_scan_matches_host_loop(repo_root):
    """plan_scan (device-resident multi-cycle scan) drives ZAM_Over to the
    goal with the same steps as the host replanning loop on the fast path;
    recorded trajectories agree to f32-grid resolution."""
    from tests.test_planner_e2e import _run_loop

    host = _run_loop(_make_config(repo_root, fast=True))
    assert host.goal_reached()
    want = host.record_state_list

    config = _make_config(repo_root, fast=True)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(14)

    assert info["goal_reached"]
    assert planner.goal_reached()          # planner state advanced to goal
    got = planner.record_state_list
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(want, got):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)
    # per-cycle statistics populated
    assert info["cycles_run"] >= 9
    assert all(np.isfinite(info["best_cost"]))


def test_plan_scan_scope_gate(repo_root):
    """plan_scan raises outside the fast-path scope (XLA-only configs)."""
    config = _make_config(repo_root, fast=False)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    with pytest.raises(ValueError):
        planner.plan_scan(2)


def test_plan_scan_tjunction_dense_traffic(repo_root):
    """plan_scan drives the 10-dynamic-obstacle T-junction end to end —
    yield phase included — with the same steps as the host fast loop
    (on-device level escalation must kick in when low levels are blocked)."""
    from tests.test_planner_e2e import _run_loop

    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Tjunction-1_42_T-1.yaml",
        "ZAM_Tjunction-1_42_T-1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Tjunction-1_42_T-1.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    host = _run_loop(config, max_steps=200)
    assert host.goal_reached()
    want = host.record_state_list

    config2 = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Tjunction-1_42_T-1.yaml",
        "ZAM_Tjunction-1_42_T-1.xml")
    config2.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config2.general.set_path_scenario("ZAM_Tjunction-1_42_T-1.xml")
    config2.update()
    config2.debug.fast_scoring = True
    config2.debug.kernel_dtype = "float32"
    route = RoutePlanner(config2.scenario,
                         config2.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config2)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    # 50 cycles x 3 steps covers the 146-step run
    info = planner.plan_scan(50)

    assert info["goal_reached"]
    got = planner.record_state_list
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.position, a.position, atol=1e-2)


def test_plan_scan_standstill_start_ramp(repo_root):
    """plan_scan from a standstill start (ZAM-Ramp, v=0: low-velocity mode
    + arclength lateral parameterization on device): same steps as the host
    fast loop. (The host-side standstill FALLBACK never triggers here —
    the first cycle finds an accelerating trajectory.)"""
    from tests.test_planner_e2e import _run_loop

    def cfg():
        config = ReactivePlannerConfiguration.load(
            repo_root / "configurations" / "ZAM-Ramp-1_1-T-1.yaml",
            "ZAM-Ramp-1_1-T-1.xml")
        config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
        config.general.set_path_scenario("ZAM-Ramp-1_1-T-1.xml")
        config.update()
        config.debug.fast_scoring = True
        config.debug.kernel_dtype = "float32"
        return config

    host = _run_loop(cfg(), max_steps=100)
    assert host.goal_reached()

    config = cfg()
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(20)

    assert info["goal_reached"]
    want, got = host.record_state_list, planner.record_state_list
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)


def test_plan_scan_dynamic_obstacles_deu(repo_root):
    """plan_scan with time-variant obstacle windows (DEU_Test, 2 moving
    vehicles): the device window slicing at the carried time step must
    reproduce the host fast loop exactly. With this, all four bundled
    scenarios drive to goal through plan_scan."""
    from tests.test_planner_e2e import _run_loop

    def cfg():
        config = ReactivePlannerConfiguration.load(
            repo_root / "configurations" / "DEU_Test-1_1_T-1.yaml",
            "DEU_Test-1_1_T-1.xml")
        config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
        config.general.set_path_scenario("DEU_Test-1_1_T-1.xml")
        config.update()
        config.debug.fast_scoring = True
        config.debug.kernel_dtype = "float32"
        return config

    host = _run_loop(cfg(), max_steps=100)
    assert host.goal_reached()

    config = cfg()
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(16)

    assert info["goal_reached"]
    want, got = host.record_state_list, planner.record_state_list
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)


# ---------------------------------------------------------------------------
# fused-path scope closures
# ---------------------------------------------------------------------------

def _plan_with_cost(repo_root, fast, cost_function):
    config = _make_config(repo_root, fast)
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_cost_function(cost_function)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    return planner, result


def test_fail_safe_cost_on_fast_path(repo_root):
    """DefaultCostFunctionFailSafe (cost_function.py:74-92) runs through the
    fused scorer (a weight/flag switch: w_a=1, desired_d=0, no
    velocity/stopping terms) and selects the same trajectory as the XLA
    conformance path."""
    from commonroad_rp_jax.models.cost_functions import \
        DefaultCostFunctionFailSafe

    ref_planner, want = _plan_with_cost(repo_root, False,
                                        DefaultCostFunctionFailSafe())
    fast_planner, got = _plan_with_cost(repo_root, True,
                                        DefaultCostFunctionFailSafe())
    assert want is not None and got is not None
    # the fused path actually engaged (not the XLA fallback)
    assert fast_planner._scene_context()["fast_ok"]
    for a, b in zip(want[0].state_list, got[0].state_list):
        np.testing.assert_allclose(b.position, a.position, atol=1e-4)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=1e-4)
    assert fast_planner.optimal_cost == pytest.approx(
        ref_planner.optimal_cost, rel=1e-5)
    assert fast_planner.infeasible_count_kinematics == \
        ref_planner.infeasible_count_kinematics


def test_draw_traj_set_on_fast_path(repo_root):
    """Trajectory-set capture no longer forces the XLA fallback: with
    draw_traj_set the fast path stays fused for selection and captures the
    bundle with one post-selection rollout (labels identical to the XLA
    path's stored bundle)."""
    def plan(fast):
        config = _make_config(repo_root, fast)
        config.debug.draw_traj_set = True
        config.debug.save_plots = True
        route = RoutePlanner(config.scenario,
                             config.planning_problem).plan_routes() \
            .retrieve_first_route()
        planner = ReactivePlanner(config)
        planner.set_reference_path(route.reference_path)
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        result = planner.plan()
        return planner, result

    ref_planner, want = plan(False)
    fast_planner, got = plan(True)
    assert want is not None and got is not None
    assert fast_planner._scene_context()["fast_ok"], \
        "draw_traj_set must not drop the fused path anymore"

    ref_bundle = ref_planner.stored_trajectories
    bundle = fast_planner.stored_trajectories
    assert bundle is not None
    assert bundle.x.shape == ref_bundle.x.shape
    np.testing.assert_array_equal(bundle.feasible, ref_bundle.feasible)
    np.testing.assert_array_equal(bundle.collides, ref_bundle.collides)
    np.testing.assert_allclose(bundle.x, ref_bundle.x, atol=1e-3)
    np.testing.assert_allclose(bundle.y, ref_bundle.y, atol=1e-3)
    feas = bundle.feasible
    np.testing.assert_allclose(bundle.costs[feas], ref_bundle.costs[feas],
                               rtol=1e-4)
    # selection unchanged by the capture
    for a, b in zip(want[0].state_list, got[0].state_list):
        np.testing.assert_allclose(b.position, a.position, atol=1e-4)
