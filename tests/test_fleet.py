"""Fleet path: device grid generation parity + sharded replanning scan."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commonroad_rp_jax.models.sampling import FixedIntervalSampling
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration


def test_device_grid_matches_host_grid():
    """velocity_keeping_candidates reproduces FixedIntervalSampling's batch
    (modulo candidate order: both are t-major/lon/d with sorted grids)."""
    cfg = ReactivePlannerConfiguration()
    cfg.planning.time_steps_computation = 20
    cfg.sampling.t_min = 0.4
    cfg.sampling.v_min, cfg.sampling.v_max = 10.0, 20.0
    space = FixedIntervalSampling(cfg)

    x0_lon = np.array([5.0, 15.0, 0.3])
    x0_lat = np.array([0.7, 0.05, 0.01])
    level = 1
    host = space.generate_trajectories_at_level(level, x0_lon, x0_lat,
                                                "velocity_keeping", False)

    grid = grid_ops.make_static_grid(level, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    c_lon, c_lat, traj_len = grid_ops.velocity_keeping_candidates(
        jnp.asarray(x0_lon), jnp.asarray(x0_lat), jnp.asarray(10.0),
        jnp.asarray(20.0), jnp.asarray(False), grid)

    # host batch d-grid is np.unique(sorted) incl. x0_lat[0]; device appends
    # x0_lat[0] last — compare as sets of (t, v_target, d_end, coeff) rows
    def key_rows(cl, ca, tl):
        rows = np.concatenate([np.asarray(cl), np.asarray(ca),
                               np.asarray(tl)[:, None]], axis=1)
        return rows[np.lexsort(rows.T[::-1])]

    host_rows = key_rows(host.coeffs_lon, host.coeffs_lat, host.traj_len)
    dev_rows = key_rows(c_lon, c_lat, traj_len)
    assert host_rows.shape == dev_rows.shape
    np.testing.assert_allclose(dev_rows, host_rows, rtol=1e-9, atol=1e-9)


def test_stopping_grid_shapes():
    grid = grid_ops.make_static_grid(2, 0.4, 2.0, 0.1, -3.0, 3.0, 4)
    c_lon, c_lat, traj_len, goal_valid = grid_ops.stopping_candidates(
        jnp.asarray([5.0, 3.0, 0.0]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray(10.0), jnp.asarray(14.0), jnp.asarray(False), grid)
    assert c_lon.shape == (grid.size, 6)
    # all stop targets ahead of s0=5 -> all goal-valid
    assert bool(jnp.all(goal_valid))
    # stopping polynomials are quintic: c5 generally nonzero
    assert float(jnp.max(jnp.abs(c_lon[:, 5]))) > 0


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dryrun_multichip(n_devices, repo_root):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", repo_root / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.dryrun_multichip(n_devices)


def test_entry_compiles(repo_root):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", repo_root / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn, args = module.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    carry, metrics = out
    assert bool(metrics[0]), "entry cycle should find a trajectory"


def test_traj_length_matches_numpy_arange():
    """traj_length_steps must equal len(np.arange(0, round(dtau+dt,5), dt))
    (the reference's per-candidate time array, reactive_planner.py:733)."""
    from commonroad_rp_jax.models.sampling import traj_length_steps
    dt = 0.1
    taus = np.concatenate([np.arange(0.2, 6.01, 0.1),
                           [0.4000000001, 1.9999999999, 2.0000000001]])
    got = traj_length_steps(taus, dt)
    want = np.array([len(np.arange(0, np.round(t + dt, 5), dt)) for t in taus])
    np.testing.assert_array_equal(got, want)


def test_mixed_scenario_fleet(repo_root):
    """A fleet stacking all four bundled scenarios (different path lengths,
    obstacle counts, boundary sizes) pads and plans coherently."""
    import jax
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    n_steps, dt = 20, 0.1
    problems = []
    for name in ["ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM_Tjunction-1_42_T-1",
                 "ZAM-Ramp-1_1-T-1"]:
        scenario, pp, _ = load_scenario_and_planning_problem(
            str(repo_root / "example_scenarios" / f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        problems.append(fleet_ops.problem_from_planner_setup(
            scenario, pp, route.reference_path, n_steps=n_steps,
            horizon_pad=30, dtype=jnp.float32))

    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    assert scene.obs_pose.shape[0] == 4

    veh_cfg = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[np.float32(x) for x in [
        veh_cfg.wheelbase, veh_cfg.wb_rear_axle, veh_cfg.a_max,
        veh_cfg.v_switch, np.tan(veh_cfg.delta_max) / veh_cfg.wheelbase,
        veh_cfg.v_delta_max, veh_cfg.length / 2, veh_cfg.width / 2]])
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    run = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(4), veh, grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=3)
    final_carry, metrics = run(carry, scene)
    jax.block_until_ready(final_carry)

    found = np.asarray(metrics.found)          # [cycles, F]
    # all four scenarios plan successfully from cycle one — including the
    # ramp's standstill start (v=0: the velocity window spans [0, 5] and
    # low-velocity mode parameterizes the lateral by arclength)
    assert found[0].all(), found[0]
    # fleet aggregate equals the per-problem sum on every cycle
    np.testing.assert_array_equal(np.asarray(metrics.fleet_success),
                                  found.sum(axis=1))


def test_heterogeneous_vehicle_fleet(repo_root):
    """Per-problem vehicle parameters (scene.veh) drive the constraints: a
    Ford Escort's tighter steering limit rejects more candidates than the
    BMW 320i's on the same scene."""
    import jax
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    n_steps, dt = 20, 0.1
    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()

    problems = [
        fleet_ops.problem_from_planner_setup(
            scenario, pp, route.reference_path, n_steps=n_steps,
            horizon_pad=30, dtype=jnp.float32,
            vehicle=VehicleConfiguration(id_type_vehicle=vid))
        for vid in (1, 2, 3)]
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps,
                                               dtype=jnp.float32)
    # per-problem kappa_max differs across vehicle types
    kappas = np.asarray(scene.veh.kappa_max)
    assert len(set(np.round(kappas, 6))) == 3

    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    step = fleet_ops.make_fleet_step(
        make_fleet_mesh(1), veh=None, static_grid=grid, dt=dt,
        n_steps=n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * dt)
    new_carry, metrics = jax.jit(step)(carry, scene)
    jax.block_until_ready(new_carry)
    assert bool(np.all(np.asarray(metrics.found))), \
        "all three vehicle types should plan on ZAM_Over"


def _over_problem(repo_root, n_steps=10):
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    scenario, pp, _ = load_scenario_and_planning_problem(
        str(repo_root / "example_scenarios" / "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    return fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=30,
        dtype=jnp.float32)


def _fleet_runner(mesh, n_steps=10, n_cycles=3):
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.utils.config import VehicleConfiguration

    veh_cfg = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(
        wheelbase=np.float32(veh_cfg.wheelbase),
        wb_rear_axle=np.float32(veh_cfg.wb_rear_axle),
        a_max=np.float32(veh_cfg.a_max), v_switch=np.float32(veh_cfg.v_switch),
        kappa_max=np.float32(np.tan(veh_cfg.delta_max) / veh_cfg.wheelbase),
        v_delta_max=np.float32(veh_cfg.v_delta_max),
        half_length=np.float32(0.5 * veh_cfg.length),
        half_width=np.float32(0.5 * veh_cfg.width))
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * 0.1, 0.1, -3.0, 3.0, 4)
    return fleet_ops.make_fleet_rollout(
        mesh, veh, grid, 0.1, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * 0.1, n_cycles=n_cycles)


def test_fleet_uneven_shards(repo_root):
    """F=5 problems on a 4-device mesh: pad_fleet pads with dead members;
    real-member results match the unpadded 1-device run and aggregates
    count only live problems."""
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh

    problem = _over_problem(repo_root)
    F = 5
    problems = [problem] * F
    scene, carry = fleet_ops.build_fleet_scene(problems, 10, dtype=jnp.float32)

    # reference: unpadded on a single device
    run1 = _fleet_runner(make_fleet_mesh(1))
    final1, metrics1 = run1(carry, scene)

    # padded to 8 on a 4-device mesh
    scene_p, carry_p, F_real = fleet_ops.pad_fleet(scene, carry, 4)
    assert F_real == F and carry_p.alive.shape[0] == 8
    assert not bool(np.asarray(carry_p.alive)[F:].any())
    run4 = _fleet_runner(make_fleet_mesh(4))
    final4, metrics4 = run4(carry_p, scene_p)

    np.testing.assert_allclose(np.asarray(final4.x0_lon)[:F],
                               np.asarray(final1.x0_lon), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(metrics4.found)[:, :F],
                                  np.asarray(metrics1.found))
    # padded members stay dead and never count
    assert not bool(np.asarray(metrics4.found)[:, F:].any())
    assert np.all(np.isinf(np.asarray(metrics4.best_cost)[:, F:]))
    np.testing.assert_array_equal(np.asarray(metrics4.fleet_success),
                                  np.asarray(metrics1.fleet_success))
    np.testing.assert_allclose(np.asarray(metrics4.fleet_mean_cost),
                               np.asarray(metrics1.fleet_mean_cost),
                               rtol=1e-6)


def test_fleet_mid_scan_checkpoint_resume(repo_root, tmp_path):
    """6-cycle scan == 3 cycles + checkpoint roundtrip + 3 more cycles
    (bitwise carries; stacked metrics match)."""
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.checkpoint import (load_fleet_carry,
                                                    save_fleet_carry)

    problem = _over_problem(repo_root)
    scene, carry = fleet_ops.build_fleet_scene([problem] * 4, 10,
                                               dtype=jnp.float32)
    mesh = make_fleet_mesh(2)

    run6 = _fleet_runner(mesh, n_cycles=6)
    final6, metrics6 = run6(carry, scene)

    run3 = _fleet_runner(mesh, n_cycles=3)
    mid, metrics_a = run3(carry, scene)
    path = str(tmp_path / "fleet_mid.npz")
    save_fleet_carry(mid, cycle_index=3, path=path)
    restored, cycle_index = load_fleet_carry(path)
    assert cycle_index == 3
    final_r, metrics_b = run3(restored, scene)

    for a, b in zip(final6, final_r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(metrics6.found),
        np.concatenate([np.asarray(metrics_a.found),
                        np.asarray(metrics_b.found)]))
    np.testing.assert_array_equal(
        np.asarray(metrics6.best_cost),
        np.concatenate([np.asarray(metrics_a.best_cost),
                        np.asarray(metrics_b.best_cost)]))


def test_fleet_disc_obstacles_xla_vs_pallas(repo_root, tmp_path):
    """Fleet scenes with CIRCLE obstacles: the radius column flows through
    build_fleet_scene into both fleet scans; the dense scan and the fused-scorer
    scan agree on per-cycle success and carries for a disc-blocked lane."""
    import textwrap

    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel import pallas_fleet
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner
    from tests.test_circle_obstacle_e2e import _SCENARIO

    path = tmp_path / "SYN_Disc-1_1.xml"
    path.write_text(textwrap.dedent(_SCENARIO))
    scenario, pp, _ = load_scenario_and_planning_problem(str(path))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    n_steps = 15
    problem = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=30,
        dtype=jnp.float32)
    # polygon group is facade-only on the fleet path: strip it (the XML has
    # a triangle too) and keep the disc + boundary corridor
    from commonroad_rp_jax.ops.collision import ObstacleArrays
    obs = problem["obstacles"]
    # shift the disc toward the right edge so the single-level grid (no
    # escalation in the fleet scan) can dodge it at d = 1.5; the scenario's
    # triangle (x~72..78, jutting from the left) stays as the polygon group
    pose = np.asarray(obs.pose).copy()
    pose[0, :, 1] = -2.2
    problem["obstacles"] = ObstacleArrays(pose=jnp.asarray(pose, jnp.float32),
                                          half_ext=obs.half_ext,
                                          valid=obs.valid, radius=obs.radius,
                                          poly_verts=obs.poly_verts,
                                          poly_valid=obs.poly_valid)
    assert obs.radius is not None and float(np.asarray(obs.radius)[0]) > 0
    assert obs.poly_verts is not None

    scene, carry = fleet_ops.build_fleet_scene([problem] * 2, n_steps,
                                               dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(scene.obs_radius)[:, 0], 1.8)

    # 10 cycles x 3 steps at ~15 m/s: the fleet passes the disc at x=45
    run_xla = _fleet_runner(make_fleet_mesh(1), n_steps=n_steps, n_cycles=10)
    final_x, metrics_x = run_xla(carry, scene)
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * 0.1, 0.1, -3.0, 3.0, 4)
    run_p = pallas_fleet.make_pallas_fleet_scan(
        scene, grid, 0.1, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * 0.1, n_cycles=10)
    final_p, metrics_p = run_p(carry)

    assert bool(np.asarray(metrics_x.found).all())
    np.testing.assert_array_equal(np.asarray(metrics_p[0]),
                                  np.asarray(metrics_x.found))
    np.testing.assert_allclose(np.asarray(final_p.x0_lon),
                               np.asarray(final_x.x0_lon), atol=1e-4)
    # the disc must bite: the carried lateral offset leaves the center
    # while passing it (x0 starts at d~0; metrics x confirms progress)
    assert float(np.asarray(metrics_x.x).max()) > 45.0
    assert float(np.abs(np.asarray(final_x.x0_lat)[:, 0]).max()) > 0.2


def test_xla_fleet_standstill_fallback(repo_root):
    """XLA fleet path: a blocked member at v ~ 0 plans the standstill
    fallback (pose frozen, v = 0, cost 0) and stays alive — same device
    branch as the pallas fleet scan (reactive_planner.py:638-653)."""
    import jax.numpy as jnp

    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from tests.test_pallas_fleet import _over_problem

    n_steps, dt = 20, 0.1
    problem = _over_problem(repo_root, velocity=0.04)
    scene, carry = fleet_ops.build_fleet_scene([problem], n_steps,
                                               dtype=jnp.float32)
    scene = scene._replace(
        corridor_lo=jnp.full_like(scene.corridor_lo, 0.001),
        corridor_hi=jnp.full_like(scene.corridor_hi, 0.002))
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)
    run = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(1), None, grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=4)
    final, metrics = run(carry, scene)

    found = np.asarray(metrics.found)
    assert found.all(), "standstill fallback must keep the member alive"
    np.testing.assert_array_equal(np.asarray(metrics.best_cost), 0.0)
    np.testing.assert_allclose(np.asarray(metrics.x), float(problem["px"]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(final.velocity), 0.0)
    assert int(final.time_step[0]) == 12
