"""Cost-function objects (parameter holders for the batched cost kernels).

API mirror of the reference's cost functions (reference:
commonroad_rp/cost_function.py:17-92); evaluation happens batched on device
via ``ops.cost`` — these classes carry the target-state parameters that the
planner mutates between cycles (reactive_planner.py:339-347, :369-376).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import jax.numpy as jnp

from commonroad_rp_jax.ops import cost as cost_ops
from commonroad_rp_jax.ops.kinematics import RolloutResult


class CostFunction(ABC):
    """Abstract base (cost_function.py:17-32), batched signature."""

    @abstractmethod
    def evaluate_batch(self, rollout: RolloutResult) -> jnp.ndarray:
        """[K] costs for a rollout batch."""


class DefaultCostFunction(CostFunction):
    """Comfort-driving cost (cost_function.py:35-71).

    Attributes are mutated by the planner: ``desired_speed``/``desired_s`` via
    the set_desired_* methods, ``w_a`` flips between 5 (velocity keeping) and
    1 (stopping) (reactive_planner.py:344, :376).
    """

    def __init__(self, desired_speed: Optional[float] = None,
                 desired_d: float = 0.0, desired_s: Optional[float] = None):
        self.desired_speed = desired_speed
        self.desired_d = desired_d
        self.desired_s = desired_s
        self.w_a = 5.0

    def evaluate_batch(self, rollout: RolloutResult) -> jnp.ndarray:
        dtype = rollout.v.dtype
        return cost_ops.default_cost(
            rollout, w_a=jnp.asarray(self.w_a, dtype),
            desired_d=jnp.asarray(self.desired_d, dtype),
            desired_speed=None if self.desired_speed is None
            else jnp.asarray(self.desired_speed, dtype),
            desired_s=None if self.desired_s is None
            else jnp.asarray(self.desired_s, dtype))

    # static signature of the cost structure, for jit cache keys
    @property
    def structure(self):
        return ("default", self.desired_speed is not None, self.desired_s is not None)


class DefaultCostFunctionFailSafe(CostFunction):
    """Fail-safe planning cost (cost_function.py:74-92)."""

    def evaluate_batch(self, rollout: RolloutResult) -> jnp.ndarray:
        return cost_ops.fail_safe_cost(rollout)

    @property
    def structure(self):
        return ("fail_safe",)
