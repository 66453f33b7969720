"""The fused per-level planning-cycle program (single jitted call).

This is the device heart of the planner: one compiled XLA program per
(candidate-count, horizon, mode) signature that takes the candidate batch and
scene tables and returns the selected optimal candidate plus dense
feasibility/cost/collision masks and statistics.  It replaces the reference's
entire ``_get_optimal_trajectory`` stage chain — multiprocessing kinematic
check, Python sort, lazy collision iteration (reference:
commonroad_rp/reactive_planner.py:1065-1136) — with mask + argmin semantics
(SURVEY.md section 7): compute everything dense, mask infeasible candidates
with +inf cost, take one argmin.

Selection statistics are derived to match the reference's lazy iteration:
``infeasible_count_collision`` counts kinematically feasible candidates that
collide AND rank before the winner in cost order — exactly the candidates the
reference's sorted loop would have visited (:1031-1046).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from commonroad_rp_jax import backend
from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cost as cost_ops
from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.ops import kinematics


class CostParams(NamedTuple):
    """Traced cost-function parameters (models.cost_functions.DefaultCostFunction)."""

    w_a: jnp.ndarray
    desired_d: jnp.ndarray
    desired_speed: jnp.ndarray   # ignored unless has_desired_speed
    desired_s: jnp.ndarray       # ignored unless has_desired_s


CANDIDATE_FIELDS = ("s", "s_dot", "s_ddot", "d", "d_dot", "d_ddot",
                    "theta_cl", "x", "y", "theta_gl", "v", "a", "kappa_gl",
                    "kappa_dot")


class LevelResult(NamedTuple):
    """Output of one level evaluation (everything the host needs).

    Host-facing values are packed into few arrays: every device->host
    readback is a synchronisation, so one packed transfer replaces ~19
    per-leaf transfers per cycle.
    """

    found: jnp.ndarray            # scalar bool: any feasible & collision-free
    scalars: jnp.ndarray          # [4] f: best_idx, best_cost, n_inf_kin, n_coll
                                  #     (FastLevelResult.scalars differs: [6])
    masks: jnp.ndarray            # [3, K] int32: feasible, collides, reason
    costs: jnp.ndarray            # [K] costs (all candidates)
    optimal: jnp.ndarray          # [14, T] best candidate (CANDIDATE_FIELDS order)
    rollout: kinematics.RolloutResult     # dense [K, T] state arrays (device)


def _level_costs(rollout: kinematics.RolloutResult, cost_params: CostParams,
                 cost_structure: tuple) -> jnp.ndarray:
    """[K] costs for the static cost signature
    (models.cost_functions.*.structure)."""
    kind = cost_structure[0]
    if kind == "default":
        _, has_speed, has_s = cost_structure
        return cost_ops.default_cost(
            rollout, w_a=cost_params.w_a, desired_d=cost_params.desired_d,
            desired_speed=cost_params.desired_speed if has_speed else None,
            desired_s=cost_params.desired_s if has_s else None)
    if kind == "fail_safe":
        return cost_ops.fail_safe_cost(rollout)
    raise ValueError(f"unknown cost structure {cost_structure}")


@functools.partial(
    jax.jit,
    static_argnames=("dt", "n_steps", "low_vel_mode", "cost_structure",
                     "constraint_flags", "boundary_mode", "continuous_check"))
def evaluate_level(coeffs_lon: jnp.ndarray,
                   coeffs_lat: jnp.ndarray,
                   traj_len: jnp.ndarray,
                   goal_valid: jnp.ndarray,
                   ref: frenet_ops.RefPathTables,
                   veh: kinematics.VehicleArrays,
                   obstacles: collision_ops.ObstacleArrays,
                   boundary: Optional[collision_ops.BoundaryArrays],
                   corridor: Optional[collision_ops.CorridorArrays],
                   x0_orientation: jnp.ndarray,
                   cost_params: CostParams,
                   *,
                   dt: float,
                   n_steps: int,
                   low_vel_mode: bool,
                   cost_structure: tuple,
                   constraint_flags: tuple,
                   boundary_mode: str,
                   continuous_check: bool = False) -> LevelResult:
    """Evaluate one sampling level end to end on device.

    ``goal_valid`` [K] pre-masks candidates (filter_goals_behind semantics,
    trajectories.py:545-550 — all-true in velocity mode).
    ``cost_structure`` is the static cost signature
    (models.cost_functions.*.structure); ``constraint_flags`` the 5-tuple of
    active kinematic constraints in reference order.  ``boundary_mode``
    selects the road-boundary check: 'corridor' (fast d-band gathers),
    'segments' (exact OBB-vs-segment SAT), or 'none'.
    """
    cv, ca, ck, ckd, cy = constraint_flags
    rollout = kinematics.rollout(
        coeffs_lon, coeffs_lat, traj_len, ref, veh, x0_orientation,
        dt, n_steps, low_vel_mode,
        check_velocity=cv, check_acceleration=ca, check_kappa=ck,
        check_kappa_dot=ckd, check_yaw_rate=cy)

    costs = _level_costs(rollout, cost_params, cost_structure)

    collides = collision_ops.check_collisions(
        rollout.x, rollout.y, rollout.theta_gl, obstacles,
        boundary if boundary_mode == "segments" else None,
        veh.half_length, veh.half_width, veh.wb_rear_axle)
    if boundary_mode == "corridor":
        collides = collides | collision_ops.check_corridor(
            rollout.s, rollout.d, rollout.theta_cl, ref.s, corridor,
            veh.half_length, veh.half_width, veh.wb_rear_axle)
    if continuous_check:
        # swept-OBB pass between consecutive steps (reactive_planner.py:1049-1058)
        collides = collides | collision_ops.check_collisions_continuous(
            rollout.x, rollout.y, rollout.theta_gl, obstacles,
            veh.half_length, veh.half_width, veh.wb_rear_axle)

    feasible = rollout.feasible & goal_valid
    ok = feasible & ~collides
    inf = jnp.asarray(jnp.inf, dtype=costs.dtype)
    # non-finite costs (NaN/overflow) must not win the argmin: the
    # reference's sorted iteration would skip past them to a finite winner
    masked = jnp.where(ok & jnp.isfinite(costs), costs, inf)
    best_idx = jnp.argmin(masked).astype(jnp.int32)
    best_cost = masked[best_idx]
    found = jnp.isfinite(best_cost)

    # goal-filtered candidates are removed from the bundle BEFORE the
    # kinematic check in the reference (reactive_planner.py:1076-1077), so
    # they do not count as kinematically infeasible
    n_inf_kin = jnp.sum(goal_valid & ~rollout.feasible).astype(jnp.int32)
    # lazy-iteration collision count: feasible, colliding, cheaper than winner.
    # Strict < : a colliding candidate whose cost exactly TIES the winner's is
    # not counted, while the reference's sorted loop may or may not visit it
    # depending on sort stability — the same measure-zero tie class as
    # doc/conformance.md divergence 1.
    n_coll = jnp.sum(feasible & collides & (costs < best_cost)).astype(jnp.int32)
    # if nothing survives, the lazy loop visits every feasible candidate
    n_coll_nofind = jnp.sum(feasible & collides).astype(jnp.int32)
    n_coll = jnp.where(found, n_coll, n_coll_nofind)

    # pack host-facing outputs (single transfers)
    scalars = jnp.stack([best_idx.astype(costs.dtype), best_cost,
                         n_inf_kin.astype(costs.dtype),
                         n_coll.astype(costs.dtype)])
    masks = jnp.stack([feasible.astype(jnp.int32), collides.astype(jnp.int32),
                       rollout.reason])
    optimal = jnp.stack([getattr(rollout, f)[best_idx]
                         for f in CANDIDATE_FIELDS])

    return LevelResult(found=found, scalars=scalars, masks=masks, costs=costs,
                       optimal=optimal, rollout=rollout)


@functools.partial(jax.jit, static_argnames=())
def gather_candidate(rollout: kinematics.RolloutResult, idx: jnp.ndarray):
    """Extract one candidate's state arrays as one packed [14, T] transfer
    (CANDIDATE_FIELDS order)."""
    return jnp.stack([getattr(rollout, f)[idx] for f in CANDIDATE_FIELDS])


def unpack_candidate(packed) -> dict:
    """[14, T] packed candidate -> {field: [T] numpy array}."""
    import numpy as np

    arr = np.asarray(packed)
    return {name: arr[i] for i, name in enumerate(CANDIDATE_FIELDS)}


@functools.partial(
    jax.jit,
    static_argnames=("dt", "n_steps", "cost_structure", "constraint_flags"))
def score_candidates(coeffs_lon: jnp.ndarray,
                     coeffs_lat: jnp.ndarray,
                     traj_len: jnp.ndarray,
                     goal_valid: jnp.ndarray,
                     ref: frenet_ops.RefPathTables,
                     veh: kinematics.VehicleArrays,
                     obstacles: collision_ops.ObstacleArrays,
                     corridor: collision_ops.CorridorArrays,
                     x0_orientation: jnp.ndarray,
                     cost_params: CostParams,
                     low_vel_mode: jnp.ndarray,
                     ref_s_last: Optional[jnp.ndarray] = None,
                     *,
                     dt: float,
                     n_steps: int,
                     cost_structure: tuple,
                     constraint_flags: tuple):
    """The fused scorer: three [K] rows for a candidate batch.

    Returns ``(masked, kin, reasons)``:

    * ``masked`` — the selection row: the cost where the candidate is
      kinematically feasible, inside the projection domain, goal-valid,
      collision-free against the discrete obstacles (OBB, disc and polygon
      groups) and inside the corridor road boundary; +inf elsewhere;
    * ``kin`` — the statistics row: the same cost with only the kinematic,
      domain and goal mask applied, so callers reconstruct the reference's
      rejection counters (kinematic = inf in ``kin``; colliding = finite in
      ``kin`` but inf in ``masked``) without the [K, T] state arrays;
    * ``reasons`` — int32 first-failure reason codes (kinematics.REASON_*).

    ``low_vel_mode`` may be traced.  ``ref_s_last`` bounds the projection
    domain and the corridor probes where ``ref`` carries sentinel padding
    rows past the true path end (fleet scenes); None uses ``ref.s[-1]``.
    The exact 'segments' boundary SAT and the continuous swept-OBB pass are
    not part of the dense mask: callers refine the winner lazily.

    Everything is elementwise XLA over [K, T] with native gathers; there is
    no matrix product, so no TF32 rounding can enter.  The fleet form is
    :func:`score_fleet`; ``ops.triton_scorer`` implements the same contract
    as one GPU kernel (``backend.scorer`` picks between them).
    """
    cv, ca, ck, ckd, cy = constraint_flags
    rollout = kinematics.rollout(
        coeffs_lon, coeffs_lat, traj_len, ref, veh, x0_orientation,
        dt, n_steps, low_vel_mode,
        check_velocity=cv, check_acceleration=ca, check_kappa=ck,
        check_kappa_dot=ckd, check_yaw_rate=cy)
    costs = _level_costs(rollout, cost_params, cost_structure)

    collides = collision_ops.check_collisions(
        rollout.x, rollout.y, rollout.theta_gl, obstacles, None,
        veh.half_length, veh.half_width, veh.wb_rear_axle)
    collides = collides | collision_ops.check_corridor(
        rollout.s, rollout.d, rollout.theta_cl, ref.s, corridor,
        veh.half_length, veh.half_width, veh.wb_rear_axle, s_last=ref_s_last)

    reasons = rollout.reason
    feasible = rollout.feasible
    if ref_s_last is not None:
        active = (jnp.arange(n_steps + 1, dtype=jnp.int32)[None, :]
                  < traj_len[:, None])
        beyond = jnp.any(active & (rollout.s > ref_s_last), axis=1)
        reasons = jnp.where(feasible & beyond, kinematics.REASON_DOMAIN,
                            reasons)
        feasible = feasible & ~beyond
    feasible = feasible & goal_valid
    inf = jnp.asarray(jnp.inf, costs.dtype)
    return (jnp.where(feasible & ~collides, costs, inf),
            jnp.where(feasible, costs, inf),
            reasons)


def score_fleet(*args, dt: float, n_steps: int, cost_structure: tuple,
                constraint_flags: tuple):
    """:func:`score_candidates` for F problems at once: every positional
    argument carries a leading fleet axis (the ``ObstacleArrays``,
    ``CorridorArrays``, ``RefPathTables``, ``VehicleArrays`` and
    ``CostParams`` leaves included).  Returns three [F, K] rows."""
    return jax.vmap(functools.partial(
        score_candidates, dt=dt, n_steps=n_steps,
        cost_structure=cost_structure,
        constraint_flags=constraint_flags))(*args)


def as_float32(tree):
    """A pytree with every array leaf cast to float32 (bool leaves kept)."""
    return jax.tree.map(
        lambda a: a if jnp.asarray(a).dtype == jnp.bool_
        else jnp.asarray(a, jnp.float32), tree)


class FastLevelResult(NamedTuple):
    """Output of the fused-scorer level evaluation (facade fast path).

    Same host contract as :class:`LevelResult` minus the dense state
    arrays.  The rejection COUNTERS are exact (reconstructed from the
    scorer's two cost rows with the same lazy-iteration semantics as
    :func:`evaluate_level`) and the scorer emits a per-candidate
    first-failure reason row, so the per-constraint reason dict is exact
    too — unlike the reference, which silently loses it in multiprocessing
    mode (reactive_planner.py:962-967; SURVEY.md section 5).
    """

    found: jnp.ndarray            # scalar bool
    scalars: jnp.ndarray          # [6] f32: best_idx, best_cost, n_inf_kin,
                                  #     n_coll, reroll-feasible flag, level
    costs: jnp.ndarray            # [K] masked costs (+inf infeasible/colliding)
    kin_costs: jnp.ndarray        # [K] kinematic-feasible raw costs
    reasons: jnp.ndarray          # [K] int32 first-failure codes (REASON_*)
    optimal: jnp.ndarray          # [14, T] best candidate (CANDIDATE_FIELDS)


def evaluate_level_fast(*args, **kwargs) -> FastLevelResult:
    """Trace :func:`_evaluate_level_fast` with x64 off: the fast path is
    float32 end to end, and the package enables x64 globally for the
    float64 conformance path."""
    with jax.enable_x64(False):
        return _evaluate_level_fast(*args, **kwargs)


def evaluate_levels_fast(*args, **kwargs):
    """x64-off wrapper around :func:`_evaluate_levels_fast`."""
    with jax.enable_x64(False):
        return _evaluate_levels_fast(*args, **kwargs)


@functools.partial(
    jax.jit,
    static_argnames=("dt", "n_steps", "low_vel_mode", "cost_structure",
                     "constraint_flags", "n_levels", "continuous"))
def _evaluate_levels_fast(coeffs_lon: jnp.ndarray,
                          coeffs_lat: jnp.ndarray,
                          traj_len: jnp.ndarray,
                          goal_valid: jnp.ndarray,
                          level_ids: jnp.ndarray,
                          ref: frenet_ops.RefPathTables,
                          veh: kinematics.VehicleArrays,
                          obstacles: collision_ops.ObstacleArrays,
                          corridor: collision_ops.CorridorArrays,
                          x0_orientation: jnp.ndarray,
                          cost_params: CostParams,
                          boundary: collision_ops.BoundaryArrays = None,
                          *,
                          dt: float,
                          n_steps: int,
                          low_vel_mode: bool,
                          cost_structure: tuple,
                          constraint_flags: tuple,
                          n_levels: int,
                          continuous: bool = False) -> FastLevelResult:
    """ALL sampling levels fused into ONE device dispatch (fast path).

    The candidate arrays are the concatenation of every level's batch with
    ``level_ids`` [K] marking each candidate's level.  The escalation
    semantics of the reference's while loop (reactive_planner.py:616-636) are
    reproduced on device: the winner comes from the FIRST level with any
    feasible collision-free candidate, and the statistics are the selected
    level's (the last level's when nothing is found — the loop's final
    iteration).  One scorer call + one [6] scalar / [14, T] readback serve
    the whole cycle, instead of one dispatch (and one compile signature)
    per level.

    ``boundary`` (exact 'segments' road-boundary SAT) and ``continuous``
    (swept-OBB pass, reference :1049-1058) run as LAZY per-winner
    refinement: a while_loop re-rolls the current winner, applies the exact
    XLA checks, and masks a colliding winner to +inf before re-selecting —
    the reference's sorted lazy iteration.
    """
    dtype = jnp.float32
    ref = as_float32(ref)
    veh = as_float32(veh)
    obstacles = as_float32(obstacles)
    coeffs_lon = jnp.asarray(coeffs_lon, dtype)
    coeffs_lat = jnp.asarray(coeffs_lat, dtype)
    x0_orientation = jnp.asarray(x0_orientation, dtype)
    masked, kin, reasons = backend.scorer(obstacles)(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, ref, veh, obstacles,
        as_float32(corridor), x0_orientation, as_float32(cost_params),
        jnp.asarray(low_vel_mode), dt=dt, n_steps=n_steps,
        cost_structure=cost_structure, constraint_flags=constraint_flags)

    refine_segments = boundary is not None and boundary.segments.shape[0] > 0
    if refine_segments or continuous:
        if refine_segments:
            bound32 = as_float32(boundary)
            T = n_steps + 1
            empty_obs = collision_ops.ObstacleArrays(
                pose=jnp.zeros((0, T, 3), dtype),
                half_ext=jnp.zeros((0, 2), dtype),
                valid=jnp.zeros((0, T), dtype=bool))

        def check_winner(m):
            found_i, bi, *_ = select_across_levels(m, kin, goal_valid,
                                                   level_ids, n_levels)
            ro = kinematics.rollout(
                coeffs_lon[bi][None, :], coeffs_lat[bi][None, :],
                traj_len[bi][None], ref, veh, x0_orientation, dt, n_steps,
                low_vel_mode)
            colliding = jnp.zeros((1,), dtype=bool)
            if refine_segments:
                colliding = colliding | collision_ops.check_collisions(
                    ro.x, ro.y, ro.theta_gl, empty_obs, bound32,
                    veh.half_length, veh.half_width, veh.wb_rear_axle)
            if continuous:
                colliding = colliding | \
                    collision_ops.check_collisions_continuous(
                        ro.x, ro.y, ro.theta_gl, obstacles,
                        veh.half_length, veh.half_width,
                        veh.wb_rear_axle)
            bad = found_i & colliding[0]
            m = jnp.where(bad & (jnp.arange(m.shape[0]) == bi), jnp.inf, m)
            return m, bad

        masked, _ = jax.lax.while_loop(
            lambda state: state[1], lambda state: check_winner(state[0]),
            check_winner(masked))

    (found, best_idx, best_cost, stat_level,
     n_inf_kin, n_coll) = select_across_levels(masked, kin, goal_valid,
                                               level_ids, n_levels)

    cv, ca, ck, ckd, cy = constraint_flags
    ro = kinematics.rollout(
        coeffs_lon[best_idx][None, :], coeffs_lat[best_idx][None, :],
        traj_len[best_idx][None], ref, veh, x0_orientation,
        dt, n_steps, low_vel_mode,
        check_velocity=cv, check_acceleration=ca, check_kappa=ck,
        check_kappa_dot=ckd, check_yaw_rate=cy)
    optimal = jnp.stack([getattr(ro, f)[0] for f in CANDIDATE_FIELDS])

    scalars = jnp.stack([best_idx.astype(dtype), best_cost,
                         n_inf_kin.astype(dtype), n_coll.astype(dtype),
                         ro.feasible[0].astype(dtype),
                         stat_level.astype(dtype)])
    return FastLevelResult(found=found, scalars=scalars, costs=masked,
                           kin_costs=kin, reasons=reasons.astype(jnp.int32),
                           optimal=optimal)


def select_across_levels(masked: jnp.ndarray, kin: jnp.ndarray,
                         goal_valid: jnp.ndarray, level_ids: jnp.ndarray,
                         n_levels: int):
    """Level-escalation selection over a union bundle (pure jnp, trace-safe).

    Returns (found, best_idx, best_cost, stat_level, n_inf_kin, n_coll):
    the winner comes from the FIRST level with any feasible collision-free
    candidate (reference while loop, reactive_planner.py:616-636); statistics
    follow the selected level (the last level when nothing is found).
    """
    sel = jnp.where(jnp.isnan(masked), jnp.inf, masked)
    lv = level_ids.astype(jnp.int32)
    inf = jnp.asarray(jnp.inf, masked.dtype)

    best_per_level = []
    found_per_level = []
    for l in range(n_levels):                      # static, small
        m = jnp.where(lv == l, sel, inf)
        idx = jnp.argmin(m).astype(jnp.int32)
        best_per_level.append(idx)
        found_per_level.append(jnp.isfinite(m[idx]))
    found_vec = jnp.stack(found_per_level)         # [L]
    any_found = jnp.any(found_vec)
    sel_level = jnp.argmax(found_vec).astype(jnp.int32)
    stat_level = jnp.where(any_found, sel_level, n_levels - 1)
    best_idx = jnp.stack(best_per_level)[sel_level]
    best_cost = jnp.where(any_found, sel[best_idx], inf)

    level_mask = lv == stat_level
    kin_inf = jnp.isinf(kin)
    n_inf_kin = jnp.sum(goal_valid & kin_inf & level_mask).astype(jnp.int32)
    colliding = ~kin_inf & jnp.isinf(masked) & level_mask
    n_coll = jnp.where(any_found,
                       jnp.sum(colliding & (kin < best_cost)),
                       jnp.sum(colliding)).astype(jnp.int32)
    return any_found, best_idx, best_cost, stat_level, n_inf_kin, n_coll


def _evaluate_level_fast(coeffs_lon, coeffs_lat, traj_len, goal_valid,
                         ref, veh, obstacles, corridor, x0_orientation,
                         cost_params, boundary=None, *, dt, n_steps,
                         low_vel_mode, cost_structure, constraint_flags,
                         continuous=False) -> FastLevelResult:
    """One sampling level on the fused scorer + a K=1 winner re-roll.

    Facade fast path (``config.debug.fast_scoring``): only three [K] rows
    and the winner's [14, T] pack leave the device.  Supported scope (the
    facade falls back to :func:`evaluate_level` otherwise): float32,
    default or fail-safe cost, corridor / 'segments' / no road boundary,
    discrete or continuous collision (all obstacle shapes).
    Single-level specialization of :func:`_evaluate_levels_fast`.
    """
    level_ids = jnp.zeros(coeffs_lon.shape[0], jnp.int32)
    return _evaluate_levels_fast(
        coeffs_lon, coeffs_lat, traj_len, goal_valid, level_ids, ref, veh,
        obstacles, corridor, x0_orientation, cost_params, boundary, dt=dt,
        n_steps=n_steps, low_vel_mode=low_vel_mode,
        cost_structure=cost_structure, constraint_flags=constraint_flags,
        n_levels=1, continuous=continuous)
