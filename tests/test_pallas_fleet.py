"""Replanning scans on the fused scorer vs the dense XLA
fleet path: the same problem must progress equivalently."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.parallel import fleet as fleet_ops
from commonroad_rp_jax.parallel import pallas_fleet
from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
from commonroad_rp_jax.utils.config import VehicleConfiguration
from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
from commonroad_rp_jax.utils.route import RoutePlanner


def test_pallas_replanning_scan_matches_fleet(repo_root):
    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    problem = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=60,
        dtype=dtype)

    vc = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[np.float32(x) for x in [
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2]])
    static_grid = grid_ops.make_static_grid(2, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    n_cycles = 6

    # fused-scorer scan
    run_p = pallas_fleet.make_pallas_replanning_scan(
        problem["ref_tables"], problem["corridor"], problem["obstacles"],
        veh, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt,
        desired_speed=float(problem["desired_speed"]), n_cycles=n_cycles)
    carry_p = pallas_fleet.PallasCycleCarry(
        x0_lon=jnp.asarray(problem["x0_lon"], dtype),
        x0_lat=jnp.asarray(problem["x0_lat"], dtype),
        orientation=jnp.asarray(problem["orientation"], dtype),
        velocity=jnp.asarray(problem["velocity"], dtype),
        time_step=jnp.asarray(0, jnp.int32),
        alive=jnp.asarray(True))
    final_p, metrics_p = run_p(carry_p)

    # XLA fleet path, same problem
    scene, carry_x = fleet_ops.build_fleet_scene([problem], n_steps, dtype=dtype)
    run_x = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(1), veh, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles)
    final_x, metrics_x = run_x(carry_x, scene)

    assert bool(np.all(np.asarray(metrics_p[0]))), "pallas scan should plan"
    assert bool(np.all(np.asarray(metrics_x.found)))
    # same winners -> same carried longitudinal state (f32 tolerance)
    np.testing.assert_allclose(np.asarray(final_p.x0_lon),
                               np.asarray(final_x.x0_lon[0]), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(final_p.velocity),
                               np.asarray(final_x.velocity[0]), atol=2e-3)
    # per-cycle best costs agree
    np.testing.assert_allclose(np.asarray(metrics_p[1]),
                               np.asarray(metrics_x.best_cost[:, 0]),
                               rtol=2e-3)

def test_pallas_fleet_scan_matches_xla_fleet(repo_root):
    """Multi-problem pallas fleet scan (one kernel launch per cycle over the
    (problem, tile) grid) vs the XLA fleet rollout on a 3-problem fleet built
    from two bundled scenarios."""
    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    problems = []
    for name in ["ZAM_Over-1_1.xml", "DEU_Test-1_1_T-1.xml"]:
        scenario, pp, _ = load_scenario_and_planning_problem(
            str(repo_root / "example_scenarios" / name))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        problems.append(fleet_ops.problem_from_planner_setup(
            scenario, pp, route.reference_path, n_steps=n_steps,
            horizon_pad=60, dtype=dtype))
    # duplicate with a perturbed start to make F=3 heterogeneous
    p2 = dict(problems[0])
    p2["velocity"] = problems[0]["velocity"] * 0.8
    p2["x0_lon"] = np.asarray(problems[0]["x0_lon"]) * np.array([1.0, 0.8, 1.0])
    problems.append(p2)

    static_grid = grid_ops.make_static_grid(2, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    n_cycles = 5
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps, dtype=dtype)

    run_p = pallas_fleet.make_pallas_fleet_scan(
        scene, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles)
    final_p, metrics_p = run_p(carry)

    run_x = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(1), None, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles)
    final_x, metrics_x = run_x(carry, scene)

    found_p = np.asarray(metrics_p[0])
    assert found_p.all(), "all fleet members should plan every cycle"
    np.testing.assert_array_equal(found_p, np.asarray(metrics_x.found))
    np.testing.assert_allclose(np.asarray(final_p.x0_lon),
                               np.asarray(final_x.x0_lon), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(final_p.velocity),
                               np.asarray(final_x.velocity), atol=2e-3)
    np.testing.assert_allclose(np.asarray(metrics_p[1]),
                               np.asarray(metrics_x.best_cost), rtol=2e-3)


def test_pallas_fleet_scan_dead_member_freezes(repo_root):
    """A fleet member whose corridor admits no candidate must go not-alive on
    cycle 1 and its carry must freeze while the rest of the fleet advances."""
    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    good = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=60,
        dtype=dtype)
    bad = dict(good)
    import dataclasses
    from commonroad_rp_jax.ops.collision import CorridorArrays
    # collapse the drivable band to an impossible sliver
    bad["corridor"] = CorridorArrays(
        d_lo=jnp.full_like(good["corridor"].d_lo, 0.001),
        d_hi=jnp.full_like(good["corridor"].d_hi, 0.002))

    static_grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    scene, carry = fleet_ops.build_fleet_scene([good, bad], n_steps,
                                               dtype=dtype)
    run = pallas_fleet.make_pallas_fleet_scan(
        scene, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=3)
    final, metrics = run(carry)

    found = np.asarray(metrics[0])                   # [cycles, F]
    assert found[:, 0].all(), "healthy member should keep planning"
    assert not found[:, 1].any(), "squeezed member cannot plan"
    # per-problem rejection statistics (kernel stats row): the squeezed
    # member's candidates are all kinematically fine but corridor-colliding
    n_kin_inf = np.asarray(metrics[6])               # [cycles, F]
    n_coll = np.asarray(metrics[7])
    K = static_grid.size
    assert ((n_kin_inf + n_coll) <= K).all()
    assert (n_kin_inf[:, 1] + n_coll[:, 1] == K).all(), \
        "every candidate of the squeezed member is rejected"
    assert (n_coll[:, 1] > 0).all()
    assert bool(final.alive[0]) and not bool(final.alive[1])
    np.testing.assert_allclose(np.asarray(final.x0_lon[1]),
                               np.asarray(carry.x0_lon[1]), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(final.time_step[1]),
                                  np.asarray(carry.time_step[1]))
    assert float(final.x0_lon[0, 0]) > float(carry.x0_lon[0, 0])


def test_pallas_fleet_scan_sharded_over_mesh(repo_root):
    """The mesh-sharded pallas fleet scan (shard_map over the fleet axis,
    psum aggregates) must match the unsharded scan on an 8-member fleet
    spread over the 8-device CPU mesh."""
    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    base = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=60,
        dtype=dtype)
    problems = []
    for f in range(8):
        p = dict(base)
        p["velocity"] = float(base["velocity"]) * (0.8 + 0.025 * f)
        x0 = np.asarray(base["x0_lon"], np.float64).copy()
        x0[1] *= (0.8 + 0.025 * f)
        p["x0_lon"] = x0
        problems.append(p)

    static_grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps, dtype=dtype)
    n_cycles = 3

    run_local = pallas_fleet.make_pallas_fleet_scan(
        scene, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles)
    final_l, metrics_l = run_local(carry)

    mesh = make_fleet_mesh(8)
    run_sharded = pallas_fleet.make_pallas_fleet_scan(
        scene, static_grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles,
        mesh=mesh)
    final_s, metrics_s = run_sharded(carry)

    # f32: per-shard launch shapes regroup a few reductions -> ~3e-6 noise
    np.testing.assert_allclose(np.asarray(final_s.x0_lon),
                               np.asarray(final_l.x0_lon), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(metrics_s[0]),
                                  np.asarray(metrics_l[0]))
    # psum'd aggregates equal the global reductions
    np.testing.assert_array_equal(np.asarray(metrics_s[4]),
                                  np.asarray(metrics_l[4]))
    np.testing.assert_allclose(np.asarray(metrics_s[5]),
                               np.asarray(metrics_l[5]), rtol=1e-5)


def _over_problem(repo_root, n_steps=20, velocity=None):
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    if velocity is not None:
        pp.initial_state.velocity = velocity
        pp.initial_state.yaw_rate = 0.0
        pp.initial_state.acceleration = 0.0
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    return fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=60,
        dtype=jnp.float32)


def test_fleet_standstill_fallback(repo_root):
    """A blocked fleet member at v ~ 0 must plan the standstill fallback on
    device (reactive_planner.py:638-653): pose frozen, v = 0, cost 0 — and
    STAY ALIVE instead of dropping out of the fleet."""
    n_steps, dt = 20, 0.1
    problem = _over_problem(repo_root, velocity=0.04)
    scene, carry = fleet_ops.build_fleet_scene([problem], n_steps,
                                               dtype=jnp.float32)
    # squeeze the drivable band to a sliver: every candidate collides
    scene = scene._replace(
        corridor_lo=jnp.full_like(scene.corridor_lo, 0.001),
        corridor_hi=jnp.full_like(scene.corridor_hi, 0.002))
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    n_cycles = 4
    run = pallas_fleet.make_pallas_fleet_scan(
        scene, grid, dt, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * dt, n_cycles=n_cycles)
    final, metrics = run(carry)

    alive = np.asarray(metrics[0])                     # [C, F]
    costs = np.asarray(metrics[1])
    xs, ys = np.asarray(metrics[2]), np.asarray(metrics[3])
    vs = np.asarray(metrics[9])
    assert alive.all(), "standstill fallback must keep the member alive"
    np.testing.assert_array_equal(costs, 0.0)
    np.testing.assert_array_equal(vs, 0.0)
    # pose frozen at the initial cartesian position
    np.testing.assert_allclose(xs, float(problem["px"]), atol=1e-5)
    np.testing.assert_allclose(ys, float(problem["py"]), atol=1e-5)
    assert int(final.time_step[0]) == n_cycles * 3
    np.testing.assert_allclose(np.asarray(final.velocity), 0.0)


def test_fleet_stopping_mode(repo_root):
    """Stopping mode through the fleet scan: per-problem stop targets,
    quintic lon sampling + stopping cost (w_a = 1) + goal-behind filtering;
    both members decelerate toward their targets."""
    n_steps, dt = 20, 0.1
    problems = []
    for v0 in (8.0, 7.0):
        p = dict(_over_problem(repo_root, velocity=v0))
        p["desired_speed"] = 0.0           # stopping target speed
        problems.append(p)
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    s0 = np.asarray(problems[0]["x0_lon"])[0]
    desired_s = np.asarray([s0 + 8.0, s0 + 7.0], np.float32)
    s_window = np.stack([desired_s - 1.0, desired_s + 1.0], axis=1)
    grid = grid_ops.make_static_grid(2, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    n_cycles = 8
    run = pallas_fleet.make_pallas_fleet_scan(
        scene, grid, dt, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * dt, n_cycles=n_cycles, longitudinal_mode="stopping", desired_s=desired_s,
        s_window=s_window, w_a=1.0)
    final, metrics = run(carry)

    alive = np.asarray(metrics[0])
    assert alive[0].all()                  # first cycles plan successfully
    v_final = np.asarray(final.velocity)
    assert (v_final < 3.0).all(), f"should be decelerating, v={v_final}"
    s_final = np.asarray(final.x0_lon)[:, 0]
    # approached (not overshot far beyond) the stop targets
    assert (s_final < desired_s + 2.0).all()
    assert (s_final > s0 + 2.0).all()


def test_pallas_fleet_mid_scan_resume(repo_root, tmp_path):
    """6-cycle pallas fleet scan == 3 cycles + checkpoint roundtrip +
    3 more cycles (bitwise carries, stacked metrics match) — the same
    resume guarantee the XLA path pins, on the production scorer."""
    from commonroad_rp_jax.utils.checkpoint import (load_fleet_carry,
                                                    save_fleet_carry)

    n_steps, dt = 20, 0.1
    problem = _over_problem(repo_root)
    scene, carry = fleet_ops.build_fleet_scene([problem] * 2, n_steps,
                                               dtype=jnp.float32)
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)

    def runner(n_cycles):
        return pallas_fleet.make_pallas_fleet_scan(
            scene, grid, dt, n_steps, replan_offset=3, low_vel_threshold=4.0,
            horizon=n_steps * dt, n_cycles=n_cycles)

    final6, metrics6 = runner(6)(carry)
    run3 = runner(3)
    mid, metrics_a = run3(carry)
    path = str(tmp_path / "pallas_fleet_mid.npz")
    save_fleet_carry(mid, cycle_index=3, path=path)
    restored, cycle_index = load_fleet_carry(path)
    assert cycle_index == 3
    final_r, metrics_b = run3(restored)

    for a, b in zip(final6, final_r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for i in (0, 1, 2, 3, 8, 9):           # alive, cost, x, y, theta, v
        np.testing.assert_array_equal(
            np.asarray(metrics6[i]),
            np.concatenate([np.asarray(metrics_a[i]),
                            np.asarray(metrics_b[i])]))
