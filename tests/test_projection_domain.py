"""Lateral projection-domain limits (C++ CLCS parity).

The reference's CurvilinearCoordinateSystem bounds conversions by a
projection polygon: it shrinks where reference normals cross (at lateral
distance 1/kappa on the concave side) and caps at the 20 m default limit
(pycrccosy constructor defaults, utils_coordinate_system.py:128).
Round 1 flagged only s outside the table span; these tests pin the lateral
rejection on a tight curve where the corridor check alone cannot catch it.
"""

import jax
import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.baseline import oracle
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.ops.polynomial import quartic_coeffs, quintic_coeffs
from commonroad_rp_jax.utils.coordinate_system import CoordinateSystem


def _arc_cosys(radius=6.0):
    """Left-turning arc reference path (kappa ~ 1/radius)."""
    phi = np.linspace(-0.2, np.pi, 160)
    pts = np.stack([radius * np.sin(phi), radius * (1 - np.cos(phi))], axis=1)
    return CoordinateSystem(pts, smooth_reference=False,
                            dtype=jnp.float64)


def _veh(dtype=jnp.float64):
    return kin_ops.VehicleArrays(
        wheelbase=jnp.asarray(2.5, dtype), wb_rear_axle=jnp.asarray(1.4, dtype),
        a_max=jnp.asarray(8.0, dtype), v_switch=jnp.asarray(7.3, dtype),
        kappa_max=jnp.asarray(0.35, dtype), v_delta_max=jnp.asarray(0.4, dtype),
        half_length=jnp.asarray(2.2, dtype), half_width=jnp.asarray(0.9, dtype))


def _candidates(d_ends, v=4.0, horizon=1.0):
    K = len(d_ends)
    c_lon = np.tile(np.asarray(quartic_coeffs(
        jnp.asarray([[2.0, v, 0.0]], jnp.float64), jnp.asarray([v]),
        jnp.asarray([horizon]))), (K, 1))
    x0 = np.zeros((K, 3))
    xd = np.stack([np.asarray(d_ends), np.zeros(K), np.zeros(K)], axis=1)
    c_lat = np.asarray(quintic_coeffs(jnp.asarray(x0), jnp.asarray(xd),
                                      jnp.full(K, horizon)))
    return c_lon, c_lat


def test_normal_crossing_rejected_as_domain():
    """Candidates whose |d| exceeds the normal-crossing distance 1/kappa on
    the concave side must be domain-infeasible; the convex side at the same
    |d| stays valid."""
    co = _arc_cosys(radius=6.0)
    veh = _veh()
    n_steps = 10
    dt = 0.1
    # concave side of a left turn is d > 0 (normals cross at d = radius)
    d_ends = [0.0, 3.0, 7.5, -7.5]
    c_lon, c_lat = _candidates(d_ends, horizon=n_steps * dt)
    ro = kin_ops.rollout(
        jnp.asarray(c_lon), jnp.asarray(c_lat),
        jnp.full(len(d_ends), n_steps + 1, jnp.int32), co.tables, veh,
        jnp.asarray(0.2, jnp.float64), dt, n_steps, False,
        check_velocity=False, check_acceleration=False, check_kappa=False,
        check_kappa_dot=False, check_yaw_rate=False)
    feasible = np.asarray(ro.feasible)
    reason = np.asarray(ro.reason)
    assert feasible[0] and feasible[1]
    assert not feasible[2], "d beyond 1/kappa on the concave side must fail"
    assert reason[2] == kin_ops.REASON_DOMAIN
    assert feasible[3], "convex side is unbounded by normal crossing"


def test_clcs_default_20m_cap():
    """|d| beyond the CLCS 20 m default projection limit is rejected even on
    a straight path."""
    pts = np.stack([np.linspace(0, 100, 200), np.zeros(200)], axis=1)
    co = CoordinateSystem(pts, smooth_reference=False, dtype=jnp.float64)
    veh = _veh()
    n_steps = 10
    c_lon, c_lat = _candidates([19.0, 21.0], horizon=1.0)
    ro = kin_ops.rollout(
        jnp.asarray(c_lon), jnp.asarray(c_lat),
        jnp.full(2, n_steps + 1, jnp.int32), co.tables, veh,
        jnp.asarray(0.0, jnp.float64), 0.1, n_steps, False,
        check_velocity=False, check_acceleration=False, check_kappa=False,
        check_kappa_dot=False, check_yaw_rate=False)
    feasible = np.asarray(ro.feasible)
    assert feasible[0]
    assert not feasible[1]
    assert np.asarray(ro.reason)[1] == kin_ops.REASON_DOMAIN


def test_oracle_matches_rollout_on_curved_path():
    """Oracle and XLA rollout agree on the domain partition for a fan of
    lateral targets over the tight curve."""
    co = _arc_cosys(radius=6.0)
    veh = _veh()
    n_steps = 10
    dt = 0.1
    d_ends = np.linspace(-8.0, 8.0, 17)
    c_lon, c_lat = _candidates(d_ends, horizon=n_steps * dt)
    ro = kin_ops.rollout(
        jnp.asarray(c_lon), jnp.asarray(c_lat),
        jnp.full(len(d_ends), n_steps + 1, jnp.int32), co.tables, veh,
        jnp.asarray(0.2, jnp.float64), dt, n_steps, False)
    oref = oracle.OracleRefPath.from_tables(co.tables)
    oveh = oracle.OracleVehicle(
        wheelbase=2.5, wb_rear_axle=1.4, a_max=8.0, v_switch=7.3,
        kappa_max=0.35, v_delta_max=0.4, half_length=2.2, half_width=0.9)
    constraints = ["velocity", "acceleration", "kappa", "kappa_dot",
                   "yaw_rate"]
    for k in range(len(d_ends)):
        cand = oracle.check_kinematics_one(
            c_lon[k], c_lat[k], n_steps + 1, oref, oveh, 0.2, dt, n_steps,
            False, constraints)
        assert cand.feasible == bool(np.asarray(ro.feasible)[k]), \
            (k, d_ends[k], cand.reason, int(np.asarray(ro.reason)[k]))
        if not cand.feasible and cand.reason == "domain":
            assert int(np.asarray(ro.reason)[k]) == kin_ops.REASON_DOMAIN
