"""Batched trajectory cost evaluation.

Device-batched replacement for the per-candidate DefaultCostFunction
(reference: commonroad_rp/cost_function.py:35-92): the whole bundle's costs
are one [K] reduction over the dense [K, T] state arrays.  The exact weight
structure of the reference is preserved, including its mixed squaring forms
(``(5*(v-vd))**2`` vs ``50*(v_end-vd)**2``).
"""

from __future__ import annotations

import jax.numpy as jnp

from commonroad_rp_jax.ops.kinematics import RolloutResult


def default_cost(rollout: RolloutResult,
                 w_a: jnp.ndarray,
                 desired_d: jnp.ndarray,
                 desired_speed: jnp.ndarray | None = None,
                 desired_s: jnp.ndarray | None = None) -> jnp.ndarray:
    """DefaultCostFunction.evaluate for the whole batch (cost_function.py:51-71).

    ``desired_speed``/``desired_s`` are None when unset (velocity cost and
    stopping cost are then omitted, matching the reference's None checks).
    Returns [K] costs.
    """
    # T-major internally: reductions over the major axis keep the K candidates
    # on the vector lanes (the entry transposes cancel against the rollout's
    # exit transposes under XLA)
    v, a = rollout.v.T, rollout.a.T
    s, d, theta_cl = rollout.s.T, rollout.d.T, rollout.theta_cl.T
    T = v.shape[0]

    # acceleration costs (:54)
    costs = jnp.sum((w_a * a) ** 2, axis=0)

    # velocity costs (:56-59); the mid index is int(len/2)
    if desired_speed is not None:
        costs = costs + (jnp.sum((5.0 * (v - desired_speed)) ** 2, axis=0)
                         + 50.0 * (v[-1] - desired_speed) ** 2
                         + 100.0 * (v[T // 2] - desired_speed) ** 2)

    # longitudinal stopping costs (:60-62)
    if desired_s is not None:
        costs = costs + (jnp.sum((0.25 * (desired_s - s)) ** 2, axis=0)
                         + (20.0 * (desired_s - s[-1])) ** 2)

    # lateral distance costs (:65-66)
    costs = costs + (jnp.sum((0.25 * (desired_d - d)) ** 2, axis=0)
                     + (20.0 * (desired_d - d[-1])) ** 2)

    # orientation costs (:68-69)
    costs = costs + (jnp.sum((0.25 * jnp.abs(theta_cl)) ** 2, axis=0)
                     + (5.0 * jnp.abs(theta_cl[-1])) ** 2)
    return costs


def fail_safe_cost(rollout: RolloutResult) -> jnp.ndarray:
    """DefaultCostFunctionFailSafe.evaluate for the batch (cost_function.py:74-92)."""
    a, d, theta_cl = rollout.a.T, rollout.d.T, rollout.theta_cl.T
    costs = jnp.sum((1.0 * a) ** 2, axis=0)
    costs = costs + jnp.sum((0.25 * d) ** 2, axis=0) + (20.0 * d[-1]) ** 2
    costs = costs + (jnp.sum((0.25 * jnp.abs(theta_cl)) ** 2, axis=0)
                     + (5.0 * jnp.abs(theta_cl[-1])) ** 2)
    return costs
