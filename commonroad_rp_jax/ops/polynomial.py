"""Batched polynomial trajectory math (device).

Device-batched replacement for the reference's per-candidate quintic/quartic
boundary-value solves (reference: commonroad_rp/polynomial_trajectory.py:282-360,
which performs one 3x3 / 2x2 np.linalg.solve per candidate behind an
lru_cache).  Here the coefficients are CLOSED-FORM expressions evaluated for
the whole candidate batch at once — no linear solves, no caching.

Convention: a polynomial is its coefficient vector c[..., 6] with
p(tau) = c0 + c1 tau + c2 tau^2 + ... + c5 tau^5 (quartics have c5 = 0,
polynomial_trajectory.py:360).
"""

from __future__ import annotations

import jax.numpy as jnp


def quintic_coeffs(x_0: jnp.ndarray, x_d: jnp.ndarray, delta_tau: jnp.ndarray) -> jnp.ndarray:
    """Quintic coefficients for boundary conditions (pos, vel, acc) -> (pos, vel, acc).

    Closed-form solution of the 3x3 system solved per candidate at
    polynomial_trajectory.py:294-320.  Shapes: x_0 [..., 3], x_d [..., 3],
    delta_tau [...]; returns [..., 6].
    """
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    p1, v1, a1 = x_d[..., 0], x_d[..., 1], x_d[..., 2]
    T = delta_tau
    T2 = T * T
    T3 = T2 * T
    T4 = T2 * T2
    T5 = T4 * T

    dp = p1 - (p0 + v0 * T + 0.5 * a0 * T2)
    dv = (v1 - (v0 + a0 * T)) * T
    da = (a1 - a0) * T2

    c3 = (10.0 * dp - 4.0 * dv + 0.5 * da) / T3
    c4 = (-15.0 * dp + 7.0 * dv - da) / T4
    c5 = (6.0 * dp - 3.0 * dv + 0.5 * da) / T5
    return jnp.stack([p0, v0, 0.5 * a0, c3, c4, c5], axis=-1)


def quartic_coeffs(x_0: jnp.ndarray, v_d: jnp.ndarray, delta_tau: jnp.ndarray,
                   a_d: jnp.ndarray | float = 0.0) -> jnp.ndarray:
    """Quartic coefficients: (pos, vel, acc) initial -> (vel, acc) terminal.

    Closed-form solution of the 2x2 system at polynomial_trajectory.py:341-360
    (velocity-keeping mode: terminal acceleration 0, terminal position free).
    Shapes: x_0 [..., 3], v_d [...], delta_tau [...]; returns [..., 6].
    """
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    T = delta_tau
    T2 = T * T
    T3 = T2 * T

    dv = v_d - v0 - a0 * T
    da = a_d - a0

    c3 = dv / T2 - da / (3.0 * T)
    c4 = da / (4.0 * T2) - dv / (2.0 * T3)
    zeros = jnp.zeros_like(p0)
    return jnp.stack([p0, v0, 0.5 * a0, c3, c4, zeros], axis=-1)


def tau_powers(tau: jnp.ndarray):
    """(tau, tau^2, ..., tau^5) with the reference's exact power construction
    (t2 = t^2, t3 = t2*t, t4 = t2^2, t5 = t4*t; reactive_planner.py:733-737)."""
    t2 = jnp.square(tau)
    t3 = t2 * tau
    t4 = jnp.square(t2)
    t5 = t4 * tau
    return tau, t2, t3, t4, t5


def eval_position(c: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
    """p(tau); same term order as polynomial_trajectory.py:258-271.
    Shapes: c [..., 6] broadcast against tau [...]."""
    t, t2, t3, t4, t5 = tau_powers(tau)
    return (c[..., 0] + c[..., 1] * t + c[..., 2] * t2 + c[..., 3] * t3 +
            c[..., 4] * t4 + c[..., 5] * t5)


def eval_velocity(c: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
    """p'(tau); term order of polynomial_trajectory.py:252-256."""
    t, t2, t3, t4, _ = tau_powers(tau)
    return (c[..., 1] + 2.0 * c[..., 2] * t + 3.0 * c[..., 3] * t2 +
            4.0 * c[..., 4] * t3 + 5.0 * c[..., 5] * t4)


def eval_acceleration(c: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
    """p''(tau); term order of polynomial_trajectory.py:240-250."""
    t, t2, t3, _, _ = tau_powers(tau)
    return (2.0 * c[..., 2] + 6.0 * c[..., 3] * t + 12.0 * c[..., 4] * t2 +
            20.0 * c[..., 5] * t3)


def eval_jerk(c: jnp.ndarray, tau: jnp.ndarray) -> jnp.ndarray:
    """p'''(tau); polynomial_trajectory.py:229-238."""
    t, t2, _, _, _ = tau_powers(tau)
    return 6.0 * c[..., 3] + 24.0 * c[..., 4] * t + 60.0 * c[..., 5] * t2


def squared_jerk_integral(c: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Integral of squared jerk over [0, t] (polynomial_trajectory.py:171-190)."""
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    c3, c4, c5 = c[..., 3], c[..., 4], c[..., 5]
    return (36.0 * c3 * c3 * t + 144.0 * c3 * c4 * t2 + 240.0 * c3 * c5 * t3 +
            192.0 * c4 * c4 * t3 + 720.0 * c4 * c5 * t4 + 720.0 * c5 * c5 * t5)


def evaluate_state_at_tau(c: jnp.ndarray, tau: jnp.ndarray, tau_0: jnp.ndarray,
                          delta_tau: jnp.ndarray) -> jnp.ndarray:
    """[p, p', p''] at tau, with the reference's clamping quirk
    (polynomial_trajectory.py:192-227: tau is clamped to [tau_0, delta_tau]
    when tau - tau_0 falls outside [0, delta_tau])."""
    tau_prime = tau - tau_0
    tau_c = jnp.where(tau_prime < 0, tau_0, jnp.where(tau_prime > delta_tau, delta_tau, tau))
    return jnp.stack([eval_position(c, tau_c), eval_velocity(c, tau_c),
                      eval_acceleration(c, tau_c)], axis=-1)
