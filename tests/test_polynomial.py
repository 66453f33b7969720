"""Closed-form polynomial coefficients vs. linear-solve oracle.

The reference computes quintic/quartic coefficients with np.linalg.solve per
candidate (polynomial_trajectory.py:294-320, :341-360); our device kernels use
closed forms.  These tests verify the closed forms reproduce the solve to
float64 precision, and that boundary conditions are met exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from commonroad_rp_jax.ops import polynomial as poly


def _quintic_solve_oracle(x0, xd, T):
    """3x3 linear-solve formulation (mirrors the reference's system)."""
    p0, v0, a0 = x0
    p1, v1, a1 = xd
    t2, t3, t4, t5 = T**2, T**3, T**4, T**5
    A = np.array([[t3, t4, t5],
                  [3 * t2, 4 * t3, 5 * t4],
                  [6 * T, 12 * t2, 20 * t3]])
    b = np.array([p1 - (p0 + v0 * T + 0.5 * a0 * t2),
                  v1 - (v0 + a0 * T),
                  a1 - a0])
    x = np.linalg.solve(A, b)
    return np.array([p0, v0, 0.5 * a0, x[0], x[1], x[2]])


def _quartic_solve_oracle(x0, v_d, T):
    """2x2 linear-solve formulation (terminal acceleration 0)."""
    p0, v0, a0 = x0
    t2, t3 = T**2, T**3
    A = np.array([[3 * t2, 4 * t3], [6 * T, 12 * t2]])
    b = np.array([v_d - v0 - a0 * T, -a0])
    x = np.linalg.solve(A, b)
    return np.array([p0, v0, 0.5 * a0, x[0], x[1], 0.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quintic_matches_linear_solve(seed):
    rng = np.random.default_rng(seed)
    n = 64
    x0 = rng.normal(size=(n, 3)) * np.array([10.0, 5.0, 2.0])
    xd = rng.normal(size=(n, 3)) * np.array([10.0, 5.0, 2.0])
    T = rng.uniform(0.4, 6.0, size=n)

    got = np.asarray(poly.quintic_coeffs(jnp.asarray(x0), jnp.asarray(xd), jnp.asarray(T)))
    want = np.stack([_quintic_solve_oracle(x0[i], xd[i], T[i]) for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1])
def test_quartic_matches_linear_solve(seed):
    rng = np.random.default_rng(seed)
    n = 64
    x0 = rng.normal(size=(n, 3)) * np.array([10.0, 5.0, 2.0])
    v_d = rng.uniform(0.0, 20.0, size=n)
    T = rng.uniform(0.4, 6.0, size=n)

    got = np.asarray(poly.quartic_coeffs(jnp.asarray(x0), jnp.asarray(v_d), jnp.asarray(T)))
    want = np.stack([_quartic_solve_oracle(x0[i], v_d[i], T[i]) for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_quintic_boundary_conditions():
    x0 = jnp.array([1.0, 2.0, -0.5])
    xd = jnp.array([10.0, 0.0, 0.0])
    T = jnp.asarray(2.0)
    c = poly.quintic_coeffs(x0, xd, T)
    # initial conditions
    np.testing.assert_allclose(float(poly.eval_position(c, 0.0)), 1.0, atol=1e-12)
    np.testing.assert_allclose(float(poly.eval_velocity(c, 0.0)), 2.0, atol=1e-12)
    np.testing.assert_allclose(float(poly.eval_acceleration(c, 0.0)), -0.5, atol=1e-12)
    # terminal conditions
    np.testing.assert_allclose(float(poly.eval_position(c, T)), 10.0, atol=1e-9)
    np.testing.assert_allclose(float(poly.eval_velocity(c, T)), 0.0, atol=1e-9)
    np.testing.assert_allclose(float(poly.eval_acceleration(c, T)), 0.0, atol=1e-9)


def test_quartic_boundary_conditions():
    x0 = jnp.array([0.0, 5.0, 1.0])
    T = jnp.asarray(1.6)
    c = poly.quartic_coeffs(x0, jnp.asarray(12.0), T)
    np.testing.assert_allclose(float(poly.eval_velocity(c, T)), 12.0, atol=1e-9)
    np.testing.assert_allclose(float(poly.eval_acceleration(c, T)), 0.0, atol=1e-9)
    assert float(c[5]) == 0.0


def test_derivative_chain_consistency():
    """velocity/acceleration/jerk evaluations are consistent derivatives."""
    rng = np.random.default_rng(3)
    c = jnp.asarray(rng.normal(size=6))
    tau = jnp.linspace(0.0, 2.0, 101)
    h = 1e-6
    v_num = (poly.eval_position(c, tau + h) - poly.eval_position(c, tau - h)) / (2 * h)
    a_num = (poly.eval_velocity(c, tau + h) - poly.eval_velocity(c, tau - h)) / (2 * h)
    np.testing.assert_allclose(np.asarray(poly.eval_velocity(c, tau)), np.asarray(v_num),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(poly.eval_acceleration(c, tau)), np.asarray(a_num),
                               rtol=1e-5, atol=1e-5)


def test_squared_jerk_integral_numeric():
    rng = np.random.default_rng(4)
    c = jnp.asarray(rng.normal(size=6))
    T = 1.7
    taus = np.linspace(0.0, T, 20001)
    jerk = np.asarray(poly.eval_jerk(c, jnp.asarray(taus)))
    numeric = np.trapezoid(jerk**2, taus)
    got = float(poly.squared_jerk_integral(c, jnp.asarray(T)))
    np.testing.assert_allclose(got, numeric, rtol=1e-6)


def test_evaluate_state_clamps_like_reference():
    """tau outside [tau_0, tau_0+delta_tau] clamps (polynomial_trajectory.py:205-210)."""
    c = poly.quintic_coeffs(jnp.array([0.0, 1.0, 0.0]), jnp.array([5.0, 0.0, 0.0]),
                            jnp.asarray(2.0))
    inside = poly.evaluate_state_at_tau(c, jnp.asarray(2.0), 0.0, 2.0)
    beyond = poly.evaluate_state_at_tau(c, jnp.asarray(3.5), 0.0, 2.0)
    np.testing.assert_allclose(np.asarray(beyond), np.asarray(inside), atol=1e-12)


def test_traj_length_steps_replicates_numpy_arange():
    """traj_length_steps must equal len(np.arange(0, round(dtau+dt,5), dt))
    for EVERY dt, including ones where the fp division errs upward past an
    integer (dt=0.3) — the reference derives traj_len from that arange
    (reactive_planner.py:733), so any epsilon guard diverges."""
    import numpy as np

    from commonroad_rp_jax.models.sampling import traj_length_steps

    for dt in (0.05, 0.1, 0.2, 0.25, 0.3, 0.02, 0.04):
        taus = [k * dt * 0.5 + 0.13 for k in range(1, 60)] + \
               [n * dt for n in range(2, 40)]
        for dtau in taus:
            want = len(np.arange(0, np.round(dtau + dt, 5), dt))
            got = int(traj_length_steps(np.asarray([dtau]), dt)[0])
            assert got == want, (dt, dtau, want, got)
