"""Platform choices in one place.

The planner picks its precision, its scoring path and its scorer
implementation from the JAX backend it runs on, and every entry point keeps
compiled programs in one persistent cache directory.
"""

from __future__ import annotations

import os
import pathlib
from typing import NamedTuple, Optional

import jax

# the checkout (or install) root: the fixed home of the compile cache
ROOT = pathlib.Path(__file__).resolve().parent.parent


class BackendDefaults(NamedTuple):
    """Planner defaults for one JAX platform (``DebugConfiguration``'s
    ``kernel_dtype: auto`` and ``fast_scoring: None``)."""

    kernel_dtype: str      # "float32" or "float64"
    fast_scoring: bool     # fused scorer (True) or the conformance program


def resolve_defaults(platform: Optional[str] = None) -> BackendDefaults:
    """Defaults for ``platform`` (``jax.default_backend()`` when None).

    * ``gpu``: float32 device programs on the fused scorer — the
      production path;
    * ``cpu``: the float64 XLA conformance program, bit-level comparable
      with the float64 reference.

    Any other platform raises ``ValueError``: nothing else is supported.
    """
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return BackendDefaults(kernel_dtype="float32", fast_scoring=True)
    if platform == "cpu":
        return BackendDefaults(kernel_dtype="float64", fast_scoring=False)
    raise ValueError(f"unsupported JAX platform {platform!r}: the planner "
                     f"runs on 'gpu' (float32, fused scorer) or 'cpu' "
                     f"(float64 conformance path)")


def fleet_scorer(obstacles, platform: Optional[str] = None):
    """The fleet scorer (``ops.cycle.score_fleet`` contract) for
    ``platform`` (``jax.default_backend()`` when None): the Triton-route
    kernel on the GPU where it covers the obstacle set (no polygon group),
    the XLA scorer otherwise."""
    from commonroad_rp_jax.ops import cycle, triton_scorer

    platform = platform or jax.default_backend()
    if platform == "gpu" and triton_scorer.supports(obstacles):
        return triton_scorer.score_fleet_triton
    return cycle.score_fleet


def scorer(obstacles, platform: Optional[str] = None):
    """The single-problem scorer of ``plan()`` and the single-problem scans
    (``ops.cycle.score_candidates`` contract): :func:`fleet_scorer`'s
    choice, as a fleet of one for the kernel."""
    from commonroad_rp_jax.ops import cycle, triton_scorer

    if fleet_scorer(obstacles, platform) is cycle.score_fleet:
        return cycle.score_candidates
    return triton_scorer.score_candidates_triton


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache``, so every process of one checkout finds the
    programs another one compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(ROOT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
