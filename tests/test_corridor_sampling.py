"""CorridorSampling (adaptive sampling inside driving corridors) and other
facade-level capability switches: fail-safe cost function, continuous
collision checking.
"""

import logging

import numpy as np
import pytest

from commonroad_rp_jax.models.cost_functions import DefaultCostFunctionFailSafe
from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.models.sampling import (CorridorSampling,
                                               DrivingCorridor,
                                               sampling_space_factory)
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


def _corridor_for(x0_s: float, v0: float, dt: float = 0.1, steps: int = 40,
                  d_band: float = 2.0):
    """Synthetic corridor: widening velocity window, fixed lateral band."""
    vel = {}
    lat = {}
    for step in range(steps):
        vel[step] = (max(0.0, v0 - 5.0), v0 + 5.0)
        lat[step] = [(x0_s - 10.0, x0_s + v0 * dt * steps + 50.0,
                      -d_band, d_band)]
    return DrivingCorridor(first_step=0, velocity_intervals=vel,
                           lateral_interval_map=lat)


def _base_planner(repo_root, sampling_method=1):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.sampling.sampling_method = sampling_method
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    return planner


def test_factory_selects_corridor_sampling(repo_root):
    config = ReactivePlannerConfiguration()
    config.sampling.sampling_method = 2
    assert isinstance(sampling_space_factory(config), CorridorSampling)


def test_corridor_sampling_generates_candidates(repo_root):
    planner = _base_planner(repo_root, sampling_method=2)
    x0_lon, x0_lat = planner.x_0_cl
    planner.sampling_space.driving_corridor = _corridor_for(x0_lon[0],
                                                           planner.x_0.velocity)
    batch = planner.sampling_space.generate_trajectories_at_level(
        1, np.asarray(x0_lon), np.asarray(x0_lat), "velocity_keeping", False)
    assert batch.size > 20
    # all sampled lateral targets within the corridor band
    assert np.all(batch.d_sample >= -2.0) and np.all(batch.d_sample <= 2.0)
    # velocity samples within the corridor velocity window
    assert np.all(batch.lon_sample >= planner.x_0.velocity - 5.0 - 1e-9)
    assert np.all(batch.lon_sample <= planner.x_0.velocity + 5.0 + 1e-9)


def test_corridor_sampling_plan_cycle(repo_root):
    planner = _base_planner(repo_root, sampling_method=2)
    x0_lon, _ = planner.x_0_cl
    # the overtake needs |d| >= ~2.6 to clear the obstacle: a corridor from
    # reachability analysis would provide that room
    planner.sampling_space.driving_corridor = _corridor_for(
        x0_lon[0], planner.x_0.velocity, d_band=3.5)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    # selected candidate stays inside the corridor's lateral band
    _, _, lon_list, lat_list = result
    assert all(abs(lat[0]) <= 4.0 for lat in lat_list)


def test_fail_safe_cost_function(repo_root):
    planner = _base_planner(repo_root)
    planner.set_cost_function(DefaultCostFunctionFailSafe())
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None
    # fail-safe cost has no velocity tracking: the planner still returns a
    # feasible trajectory, selected purely on comfort/lateral terms
    assert planner.optimal_cost >= 0.0


def test_continuous_collision_flag(repo_root):
    planner = _base_planner(repo_root)
    planner.config.planning.continuous_collision_check = True
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    result = planner.plan()
    assert result is not None


def _reference_corridor_batch(space, level, x_0_lon, x_0_lat):
    """The reference's per-candidate triple loop (sampling.py:340-397) —
    golden generator for the vectorized production implementation."""
    from commonroad_rp_jax.models.sampling import (CandidateBatch,
                                                   quartic_coeffs_np,
                                                   quintic_coeffs_np,
                                                   traj_length_steps)
    x_0_lon = np.asarray(x_0_lon, dtype=np.float64)
    x_0_lat = np.asarray(x_0_lat, dtype=np.float64)
    num = space._num_samples[level]
    corridor = space.driving_corridor
    rows = {k: [] for k in ("c_lon", "c_lat", "t", "lon", "d")}
    for t in space.samples_t.samples_at_level(level):
        time_step = round(t / space.dt) + corridor.first_step
        v_lo, v_hi = corridor.velocity_interval(time_step)
        for v in np.unique(np.linspace(v_lo, v_hi, num)):
            c_lon = quartic_coeffs_np(x_0_lon, np.float64(v), np.float64(t))
            s_end = float(np.polyval(c_lon[::-1], t))
            for d_lo, d_hi in corridor.lateral_intervals(time_step, s_end):
                d_samples = np.unique(np.linspace(d_lo, d_hi, num))
                if d_lo < 0 < d_hi:
                    d_samples = np.unique(np.concatenate([d_samples, [0.0]]))
                for d in d_samples:
                    c_lat = quintic_coeffs_np(
                        x_0_lat, np.array([d, 0.0, 0.0]), np.float64(t))
                    rows["c_lon"].append(c_lon)
                    rows["c_lat"].append(c_lat)
                    rows["t"].append(t)
                    rows["lon"].append(v)
                    rows["d"].append(d)
    t_arr = np.asarray(rows["t"])
    return CandidateBatch(
        coeffs_lon=np.asarray(rows["c_lon"]).reshape(-1, 6),
        coeffs_lat=np.asarray(rows["c_lat"]).reshape(-1, 6),
        delta_tau=t_arr, delta_tau_lat=t_arr,
        traj_len=traj_length_steps(t_arr, space.dt),
        t_sample=t_arr, lon_sample=np.asarray(rows["lon"]),
        d_sample=np.asarray(rows["d"]),
        lon_x0_pos=np.full(t_arr.shape, x_0_lon[0]),
        lon_xd_pos=np.full(t_arr.shape, np.nan))


@pytest.mark.fast
def test_corridor_sampling_vectorized_matches_loop(repo_root):
    """The broadcasted corridor grid reproduces the per-candidate loop
    BIT-FOR-BIT: same candidate set, same order, same coefficients —
    including multi-interval steps, zero-insertion, and degenerate windows.
    Coefficients are compared at 1 ulp: numpy's SCALAR ``T**4`` and ARRAY
    ``T**4`` (pow loop vs scalar pow) differ in the last bit, an irreducible
    vectorization artifact (measured: 0x...23f vs 0x...23e for T=1.4)."""
    planner = _base_planner(repo_root, sampling_method=2)
    x0_lon, x0_lat = planner.x_0_cl
    space = planner.sampling_space
    s0, v0 = float(np.asarray(x0_lon)[0]), planner.x_0.velocity

    # adversarial corridor: two disjoint lateral intervals (one spanning 0,
    # one not), a degenerate velocity window at some steps, per-step variation
    vel, lat = {}, {}
    for step in range(60):
        if step % 7 == 3:
            vel[step] = (v0, v0)                       # degenerate window
        else:
            vel[step] = (max(0.0, v0 - 4.0 - 0.05 * step), v0 + 3.0)
        span = (s0 - 10.0, s0 + 250.0)
        lat[step] = [(span[0], span[1], -2.5, 1.5),
                     (span[0], span[1], 2.0, 3.0 + 0.01 * step)]
        if step % 5 == 0:
            lat[step].append((s0 + 30.0, s0 + 60.0, -4.0, -3.0))
    space.driving_corridor = DrivingCorridor(
        first_step=0, velocity_intervals=vel, lateral_interval_map=lat)

    for level in range(space.num_sampling_levels):
        got = space.generate_trajectories_at_level(
            level, np.asarray(x0_lon), np.asarray(x0_lat),
            "velocity_keeping", False)
        want = _reference_corridor_batch(space, level, x0_lon, x0_lat)
        assert got.size == want.size, f"level {level}"
        for field in ("delta_tau", "traj_len", "t_sample", "lon_sample",
                      "d_sample", "lon_x0_pos"):
            np.testing.assert_array_equal(
                getattr(got, field), getattr(want, field),
                err_msg=f"level {level}: {field}")
        for field in ("coeffs_lon", "coeffs_lat"):
            np.testing.assert_allclose(
                getattr(got, field), getattr(want, field),
                rtol=5e-16, atol=0.0, err_msg=f"level {level}: {field}")


def _fast_corridor_planner(repo_root, fast: bool):
    """Corridor-sampling planner with the fast-scoring flags resolved at
    CONSTRUCTION (kernel_dtype is read when the planner is built)."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.sampling.sampling_method = 2
    config.debug.fast_scoring = fast
    config.debug.kernel_dtype = "float32"
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    return planner


def test_corridor_candidates_device_matches_host(repo_root):
    """Device corridor lattice (ops.grid.corridor_candidates, the plan_scan
    generation path) reproduces the host CorridorSampling batch: identical
    candidate set and lattice order under goal_valid compression."""
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import grid as grid_ops

    planner = _base_planner(repo_root, sampling_method=2)
    x0_lon, x0_lat = planner.x_0_cl
    planner.sampling_space.driving_corridor = _corridor_for(
        x0_lon[0], planner.x_0.velocity, d_band=3.5)
    for level in (1, 2, 3):
        batch = planner.sampling_space.generate_trajectories_at_level(
            level, np.asarray(x0_lon), np.asarray(x0_lat),
            "velocity_keeping", False)
        cg = grid_ops.make_corridor_grid(planner.sampling_space, level,
                                         planner.dt)
        cl, ca, tl, gv = grid_ops.corridor_candidates(
            jnp.asarray(np.asarray(x0_lon), jnp.float32),
            jnp.asarray(np.asarray(x0_lat), jnp.float32), cg)
        gv = np.asarray(gv)
        assert int(gv.sum()) == batch.size, f"level {level}"
        np.testing.assert_allclose(np.asarray(cl)[gv], batch.coeffs_lon,
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"level {level}")
        np.testing.assert_allclose(np.asarray(ca)[gv], batch.coeffs_lat,
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"level {level}")
        np.testing.assert_array_equal(np.asarray(tl)[gv], batch.traj_len,
                                      err_msg=f"level {level}")


@pytest.mark.slow
def test_corridor_plan_scan_matches_host_loop(repo_root):
    """Corridor-mode plan_scan: the device scan with
    on-device corridor lattice generation drives ZAM_Over to the goal with
    the same trajectory as the host corridor replanning loop."""
    def _host_loop(repo_root):
        planner = _fast_corridor_planner(repo_root, fast=True)
        x0_lon, _ = planner.x_0_cl
        corridor = _corridor_for(x0_lon[0], planner.x_0.velocity, d_band=3.5,
                                 steps=40)
        planner.sampling_space.driving_corridor = corridor
        planner.record_state_and_input(planner.x_0)
        optimal = None
        freq = planner.config.planning.replanning_frequency
        while not planner.goal_reached() and \
                len(planner.record_state_list) <= 60:
            count = len(planner.record_state_list) - 1
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
                          initial_state_curv=(optimal[2][offset],
                                              optimal[3][offset]),
                          collision_checker=planner.collision_checker,
                          coordinate_system=planner.coordinate_system)
        return planner

    host = _host_loop(repo_root)
    assert host.goal_reached()
    want = host.record_state_list

    planner = _fast_corridor_planner(repo_root, fast=True)
    x0_lon, _ = planner.x_0_cl
    planner.sampling_space.driving_corridor = _corridor_for(
        x0_lon[0], planner.x_0.velocity, d_band=3.5, steps=40)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(14)

    assert info["goal_reached"]
    got = planner.record_state_list
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(want, got):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)


def test_corridor_fast_path_matches_xla(repo_root):
    """Corridor batches through the fused-scorer fast path: plan() with
    fast_scoring on/off picks the same trajectory (the kernel is
    batch-agnostic; corridor candidates need no fallback)."""
    results = []
    for fast in (False, True):
        planner = _fast_corridor_planner(repo_root, fast=fast)
        x0_lon, _ = planner.x_0_cl
        planner.sampling_space.driving_corridor = _corridor_for(
            x0_lon[0], planner.x_0.velocity, d_band=3.5)
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        result = planner.plan()
        assert result is not None
        results.append(result)
    xla, fast = results
    np.testing.assert_allclose(
        [s.velocity for s in fast[0].state_list],
        [s.velocity for s in xla[0].state_list], atol=1e-4)
    np.testing.assert_allclose(
        np.stack([s.position for s in fast[0].state_list]),
        np.stack([s.position for s in xla[0].state_list]), atol=1e-4)
