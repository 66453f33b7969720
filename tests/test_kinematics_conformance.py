"""Conformance: batched device rollout vs. the per-candidate numpy oracle.

The dense [K, T] kernel (ops.kinematics) must reproduce the reference
semantics embodied by baseline.oracle — same feasibility decisions, same
infeasibility reasons, matching state arrays, identical cost ranking — in
float64 on CPU (SURVEY.md section 7: bit-consistent selection).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from commonroad_rp_jax.baseline import oracle
from commonroad_rp_jax.models.sampling import FixedIntervalSampling
from commonroad_rp_jax.ops import cost as cost_ops
from commonroad_rp_jax.ops import frenet
from commonroad_rp_jax.ops import kinematics
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration

CONSTRAINTS = ["velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate"]
REASON_BY_CODE = {**kinematics.REASON_NAMES, kinematics.REASON_DOMAIN: "domain"}


def _curved_ref_path(n=400):
    """Gentle S-curve, ~200 m long."""
    xs = np.linspace(0.0, 200.0, n)
    ys = 8.0 * np.sin(xs / 60.0)
    return np.stack([xs, ys], axis=1)


def _vehicle(cfg):
    v = cfg.vehicle
    return kinematics.VehicleArrays(
        wheelbase=jnp.float64(v.wheelbase), wb_rear_axle=jnp.float64(v.wb_rear_axle),
        a_max=jnp.float64(v.a_max), v_switch=jnp.float64(v.v_switch),
        kappa_max=jnp.float64(v.kappa_max), v_delta_max=jnp.float64(v.v_delta_max),
        half_length=jnp.float64(v.length / 2), half_width=jnp.float64(v.width / 2))


def _oracle_vehicle(cfg):
    v = cfg.vehicle
    return oracle.OracleVehicle(
        wheelbase=v.wheelbase, wb_rear_axle=v.wb_rear_axle, a_max=v.a_max,
        v_switch=v.v_switch, kappa_max=v.kappa_max, v_delta_max=v.v_delta_max,
        half_length=v.length / 2, half_width=v.width / 2)


@pytest.fixture(scope="module")
def setup():
    cfg = ReactivePlannerConfiguration()
    cfg.planning.time_steps_computation = 20  # horizon 2 s, bundled configs
    cfg.sampling.t_min = 0.4
    tables = frenet.from_polyline(_curved_ref_path(), dtype=jnp.float64)
    return cfg, tables, oracle.OracleRefPath.from_tables(tables)


@pytest.mark.parametrize("v0,low_vel", [(15.0, False), (2.0, True), (8.0, False)])
def test_rollout_matches_oracle(setup, v0, low_vel, level=1):
    cfg, tables, oref = setup
    cfg.sampling.v_min = max(0.0, v0 - 5.0)
    cfg.sampling.v_max = v0 + 5.0
    space = FixedIntervalSampling(cfg)

    x_0_lon = np.array([40.0, v0, 0.0])
    x_0_lat = np.array([0.5, 0.1 if not low_vel else 0.02, 0.0])
    x0_theta = 0.12

    batch = space.generate_trajectories_at_level(level, x_0_lon, x_0_lat,
                                                 "velocity_keeping", low_vel)
    assert batch.size > 50

    N = cfg.planning.time_steps_computation
    res = kinematics.rollout(
        jnp.asarray(batch.coeffs_lon), jnp.asarray(batch.coeffs_lat),
        jnp.asarray(batch.traj_len), tables, _vehicle(cfg),
        jnp.float64(x0_theta), cfg.planning.dt, N, low_vel)

    ocands = oracle.evaluate_batch(batch, oref, _oracle_vehicle(cfg), x0_theta,
                                   cfg.planning.dt, N, low_vel, CONSTRAINTS,
                                   w_a=5.0, desired_d=0.0, desired_speed=v0)

    got_feasible = np.asarray(res.feasible)
    want_feasible = np.array([c.feasible for c in ocands])
    np.testing.assert_array_equal(got_feasible, want_feasible)
    assert got_feasible.sum() > 0, "test setup should yield feasible candidates"

    # reasons for the infeasible ones
    got_reason = np.asarray(res.reason)
    for k, cand in enumerate(ocands):
        if not cand.feasible:
            assert REASON_BY_CODE[int(got_reason[k])] == cand.reason, \
                f"candidate {k}: reason mismatch"

    # arrays of feasible candidates
    keys = ["x", "y", "theta_gl", "theta_cl", "v", "a", "kappa_gl",
            "kappa_dot", "s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot"]
    dev = {"x": res.x, "y": res.y, "theta_gl": res.theta_gl,
           "theta_cl": res.theta_cl, "v": res.v, "a": res.a,
           "kappa_gl": res.kappa_gl, "kappa_dot": res.kappa_dot, "s": res.s,
           "s_dot": res.s_dot, "s_ddot": res.s_ddot, "d": res.d,
           "d_dot": res.d_dot, "d_ddot": res.d_ddot}
    for k, cand in enumerate(ocands):
        if cand.feasible:
            for key in keys:
                np.testing.assert_allclose(
                    np.asarray(dev[key][k]), cand.arrays[key], rtol=1e-9,
                    atol=1e-9, err_msg=f"candidate {k} array {key}")

    # cost ranking
    costs_dev = np.asarray(cost_ops.default_cost(
        res, w_a=jnp.float64(5.0), desired_d=jnp.float64(0.0),
        desired_speed=jnp.float64(v0)))
    costs_oracle = np.array([c.cost for c in ocands])
    feas = got_feasible
    np.testing.assert_allclose(costs_dev[feas], costs_oracle[feas],
                               rtol=1e-9, atol=1e-9)
    masked_dev = np.where(feas, costs_dev, np.inf)
    masked_orc = np.where(feas, costs_oracle, np.inf)
    assert int(np.argmin(masked_dev)) == int(np.argmin(masked_orc))


def test_enlarge_extends_short_candidates(setup):
    """Short candidates (t < horizon) are constant-acceleration extended to
    N+1 steps (trajectories.py:168-197)."""
    cfg, tables, oref = setup
    cfg.sampling.v_min, cfg.sampling.v_max = 10.0, 20.0
    space = FixedIntervalSampling(cfg)
    batch = space.generate_trajectories_at_level(1, np.array([40.0, 15.0, 0.0]),
                                                 np.array([0.0, 0.0, 0.0]),
                                                 "velocity_keeping", False)
    short = batch.traj_len < cfg.planning.time_steps_computation + 1
    assert short.any(), "level grid should include durations below the horizon"
    N = cfg.planning.time_steps_computation
    res = kinematics.rollout(
        jnp.asarray(batch.coeffs_lon), jnp.asarray(batch.coeffs_lat),
        jnp.asarray(batch.traj_len), tables, _vehicle(cfg),
        jnp.float64(0.0), cfg.planning.dt, N, False)
    # all arrays span N+1 steps and the extension is constant-acceleration
    assert res.v.shape[1] == N + 1
    k = int(np.argmax(short))
    tl = int(batch.traj_len[k])
    a_ext = np.asarray(res.a[k, tl:])
    np.testing.assert_allclose(a_ext, np.asarray(res.a[k, tl - 1]), atol=1e-12)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_randomized_conformance_sweep(setup, seed):
    """Randomized initial states, velocity windows, and sampling levels: the
    dense kernel must track the oracle across the operating envelope."""
    cfg, tables, oref = setup
    rng = np.random.default_rng(seed)

    v0 = float(rng.uniform(0.5, 22.0))
    low_vel = v0 < cfg.planning.low_vel_mode_threshold
    cfg.sampling.v_min = max(0.0, v0 - rng.uniform(2.0, 6.0))
    cfg.sampling.v_max = v0 + rng.uniform(2.0, 6.0)
    space = FixedIntervalSampling(cfg)

    x_0_lon = np.array([rng.uniform(15.0, 120.0), v0, rng.uniform(-2.0, 2.0)])
    x_0_lat = np.array([rng.uniform(-2.5, 2.5), rng.uniform(-0.3, 0.3),
                        rng.uniform(-0.2, 0.2)])
    x0_theta = float(rng.uniform(-0.3, 0.3))
    level = int(rng.integers(1, 4))

    batch = space.generate_trajectories_at_level(level, x_0_lon, x_0_lat,
                                                 "velocity_keeping", low_vel)
    N = cfg.planning.time_steps_computation
    res = kinematics.rollout(
        jnp.asarray(batch.coeffs_lon), jnp.asarray(batch.coeffs_lat),
        jnp.asarray(batch.traj_len), tables, _vehicle(cfg),
        jnp.float64(x0_theta), cfg.planning.dt, N, low_vel)
    ocands = oracle.evaluate_batch(batch, oref, _oracle_vehicle(cfg), x0_theta,
                                   cfg.planning.dt, N, low_vel, CONSTRAINTS,
                                   w_a=5.0, desired_d=0.0, desired_speed=v0)

    got_f = np.asarray(res.feasible)
    want_f = np.array([c.feasible for c in ocands])
    np.testing.assert_array_equal(got_f, want_f)
    got_r = np.asarray(res.reason)
    for k, cand in enumerate(ocands):
        if not cand.feasible:
            assert REASON_BY_CODE[int(got_r[k])] == cand.reason

    if got_f.any():
        costs_dev = np.asarray(cost_ops.default_cost(
            res, w_a=jnp.float64(5.0), desired_d=jnp.float64(0.0),
            desired_speed=jnp.float64(v0)))
        costs_orc = np.array([c.cost for c in ocands])
        np.testing.assert_allclose(costs_dev[got_f], costs_orc[got_f],
                                   rtol=1e-9, atol=1e-9)
        masked_dev = np.where(got_f, costs_dev, np.inf)
        masked_orc = np.where(got_f, costs_orc, np.inf)
        assert int(np.argmin(masked_dev)) == int(np.argmin(masked_orc))
