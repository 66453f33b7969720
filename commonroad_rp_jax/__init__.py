"""commonroad_rp_jax — device-batched reactive trajectory planner.

A brand-new JAX/XLA implementation of the capabilities of the CommonRoad
reactive planner (Werling-style sampling-based Frenet planner, reference:
commonroad_rp/reactive_planner.py). The planning cycle is a single batched,
jit-compiled device program: terminal-manifold grid -> closed-form polynomial
coefficients -> dense [K, T] rollout -> Frenet->Cartesian transform -> kinematic
feasibility masks -> cost -> collision masks -> masked argmin.  No per-candidate
Python objects, no lazy early-exit; infeasible candidates are masked with +inf
cost (see SURVEY.md section 7 for the architecture stance).

Subpackages
-----------
- ``models``   : planner facade, state types, sampling spaces, cost functions
- ``ops``      : device kernels (polynomial, frenet, kinematics, cost, collision, cycle)
- ``parallel`` : device-mesh sharding, fleet planning, distributed runtime
- ``utils``    : config, geometry, scenario IO, route planning, evaluation, viz
- ``baseline`` : pure-numpy conformance oracle mirroring the reference algorithm
- ``native``   : C++ host modules (curvilinear tables, scene compilation)
"""

import jax as _jax

# The conformance path (cost ranking, Werling transforms) is validated in
# float64 on CPU; enabling x64 does not change explicitly-dtyped f32 GPU
# programs (reference precision context: reactive_planner.py computes in
# numpy float64 throughout).
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration  # noqa: E402,F401


def __getattr__(name):
    # lazy to keep bare `import commonroad_rp_jax` cheap
    if name == "ReactivePlanner":
        from commonroad_rp_jax.models.planner import ReactivePlanner
        return ReactivePlanner
    raise AttributeError(name)
