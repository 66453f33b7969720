"""Device-resident replanning scans on the fused scorer.

The production deployment shapes: ``lax.scan`` over planning cycles where
each cycle generates the terminal-manifold grid on device, scores EVERY
candidate with the fused scorer (``ops.cycle.score_candidates`` — three [K]
rows per problem), selects the winner by argmin, and advances the carry by
re-rolling just the winning candidate (a [1, T] evaluation).  One problem
(:func:`make_pallas_replanning_scan`), a fleet on one device or sharded
over a mesh (:func:`make_pallas_fleet_scan`), and the facade's
level-escalating loop (:func:`make_facade_replanning_scan`).

Complements parallel.fleet (dense per-cycle rollout of the whole batch,
vmap/shard_map over many problems).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax import backend
from commonroad_rp_jax.ops import cycle as cycle_ops
from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops.collision import (BoundaryArrays, CorridorArrays,
                                             ObstacleArrays)
from commonroad_rp_jax.ops.frenet import RefPathTables


class PallasCycleCarry(NamedTuple):
    x0_lon: jnp.ndarray          # [3]
    x0_lat: jnp.ndarray          # [3]
    orientation: jnp.ndarray     # scalar
    velocity: jnp.ndarray        # scalar
    time_step: jnp.ndarray       # scalar int32
    alive: jnp.ndarray           # scalar bool


def make_pallas_replanning_scan(ref: RefPathTables,
                                corridor: CorridorArrays,
                                obstacles_full: ObstacleArrays,
                                veh: kin_ops.VehicleArrays,
                                static_grid: grid_ops.StaticGrid,
                                dt: float, n_steps: int, replan_offset: int,
                                low_vel_threshold: float, horizon: float,
                                desired_speed: float, n_cycles: int):
    """Build the jitted scan running ``n_cycles`` fused-scorer cycles."""
    dtype = jnp.float32
    T = n_steps + 1
    ref = cycle_ops.as_float32(ref)
    corridor = cycle_ops.as_float32(corridor)
    veh = cycle_ops.as_float32(veh)
    cost_params = cycle_ops.CostParams(
        w_a=dtype(5.0), desired_d=dtype(0.0),
        desired_speed=jnp.asarray(desired_speed, dtype), desired_s=dtype(0.0))
    M = obstacles_full.pose.shape[0]
    pose_all = obstacles_full.pose.astype(dtype)
    valid_all = obstacles_full.valid
    t_full = pose_all.shape[1] if M else T

    def cycle(carry: PallasCycleCarry, _):
        v_min = jnp.maximum(0.0, carry.velocity - 0.125 * horizon * veh.a_max)
        v_max = jnp.maximum(v_min + 5.0, carry.velocity + 2.0)
        low_vel = carry.velocity < low_vel_threshold

        cl, ca, tl = grid_ops.velocity_keeping_candidates(
            carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel, static_grid)
        K = cl.shape[0]

        if M:
            window_pose = jax.lax.dynamic_slice_in_dim(
                pose_all, carry.time_step, T, axis=1)
            window_valid = jax.lax.dynamic_slice_in_dim(
                valid_all, carry.time_step, T, axis=1)
            # dynamic_slice clamps the start index: beyond the prediction
            # span the window would repeat stale poses — invalidate them
            abs_step = carry.time_step + jnp.arange(T, dtype=jnp.int32)
            window_valid = window_valid & (abs_step < t_full)[None, :]
            obstacles = ObstacleArrays(
                pose=window_pose,
                half_ext=obstacles_full.half_ext.astype(dtype),
                valid=window_valid,
                radius=None if obstacles_full.radius is None
                else obstacles_full.radius.astype(dtype))
        else:
            obstacles = ObstacleArrays(pose=jnp.zeros((0, T, 3), dtype),
                                       half_ext=jnp.zeros((0, 2), dtype),
                                       valid=jnp.zeros((0, T), dtype=bool))

        costs, _, _ = backend.scorer(obstacles)(
            cl, ca, tl, jnp.ones(K, dtype=bool), ref, veh, obstacles,
            corridor, carry.orientation, cost_params, low_vel, dt=dt,
            n_steps=n_steps, cost_structure=("default", True, False),
            constraint_flags=(True,) * 5)
        best = jnp.argmin(costs)
        found = jnp.isfinite(costs[best])

        # re-roll ONLY the winner for the carry update (K = 1)
        rollout = kin_ops.rollout(cl[best][None, :], ca[best][None, :],
                                  tl[best][None], ref, veh, carry.orientation,
                                  dt, n_steps, low_vel)
        r = replan_offset
        new_carry = PallasCycleCarry(
            x0_lon=jnp.stack([rollout.s[0, r], rollout.s_dot[0, r],
                              rollout.s_ddot[0, r]]),
            x0_lat=jnp.stack([rollout.d[0, r], rollout.d_dot[0, r],
                              rollout.d_ddot[0, r]]),
            orientation=rollout.theta_gl[0, r],
            velocity=rollout.v[0, r],
            time_step=carry.time_step + r,
            alive=carry.alive & found)
        keep = lambda new, old: jnp.where(new_carry.alive, new, old)
        new_carry = PallasCycleCarry(
            x0_lon=keep(new_carry.x0_lon, carry.x0_lon),
            x0_lat=keep(new_carry.x0_lat, carry.x0_lat),
            orientation=keep(new_carry.orientation, carry.orientation),
            velocity=keep(new_carry.velocity, carry.velocity),
            time_step=jnp.where(new_carry.alive, new_carry.time_step,
                                carry.time_step),
            alive=new_carry.alive)
        metrics = (found, costs[best], rollout.x[0, r], rollout.y[0, r])
        return new_carry, metrics

    raw = jax.jit(
        lambda carry: jax.lax.scan(cycle, carry, None, length=n_cycles))

    def run(carry: PallasCycleCarry):
        # the scan is float32 end to end; the x64-off context must be active
        # BEFORE entering the jit (the package enables x64 globally)
        with jax.enable_x64(False):
            return raw(carry)

    return run

def make_pallas_fleet_scan(scene, static_grid: grid_ops.StaticGrid,
                           dt: float, n_steps: int, replan_offset: int,
                           low_vel_threshold: float, horizon: float,
                           n_cycles: int, mesh=None,
                           longitudinal_mode: str = "velocity_keeping",
                           desired_s=None, s_window=None, w_a: float = 5.0,
                           standstill_lookahead: int = 10):
    """Fleet replanning scan on the fused scorer (F problems).

    Takes a :class:`parallel.fleet.FleetScene` (stacked per-problem tables)
    and returns ``run(carry: FleetCarry) -> (carry, metrics)`` where every
    cycle scores all F problems' candidates in one call of the platform's
    fleet scorer (``backend.fleet_scorer``: the Triton kernel on the GPU)
    and only the F winning rows are re-rolled (K=1) for the carry update.

    Complements :func:`make_pallas_replanning_scan` (single problem) and
    ``parallel.fleet.make_fleet_rollout`` (dense rollout, shard_map).

    With ``mesh`` (a 1-D fleet mesh from ``parallel.mesh.make_fleet_mesh``)
    the whole scan runs under ``shard_map`` over the fleet axis: each device
    scores its F/n_devices problems and the per-cycle fleet aggregates
    (success count, mean cost) are scalar ``psum`` reductions.

    ``longitudinal_mode='stopping'`` samples quintic stop trajectories
    toward per-problem ``s_window`` [F, 2] absolute windows with the
    ``desired_s`` [F] stopping cost (``w_a`` should then be 1.0 —
    reactive_planner.py:376) and goal-behind filtering.  The standstill
    fallback (reactive_planner.py:638-653) runs per problem ON DEVICE: a
    blocked member at v ~ 0 freezes its pose at zero velocity and cost 0
    and STAYS ALIVE instead of dropping out of the fleet.
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from commonroad_rp_jax.parallel.mesh import FLEET_AXIS

    dtype = jnp.float32
    T = n_steps + 1
    with jax.enable_x64(False):
        # FleetScene pads refs with arclength sentinels stepping by 1e6
        # (fleet.build_fleet_scene); the true per-problem path length is the
        # largest arclength below the sentinel band
        s = scene.ref.s
        ref_s_last = jnp.max(
            jnp.where(s < s[:, :1] + 5e5, s, -jnp.inf), axis=1).astype(dtype)

    t_full = scene.obs_pose.shape[2]

    stopping = longitudinal_mode == "stopping"
    if stopping and (desired_s is None or s_window is None):
        raise ValueError("stopping mode requires desired_s and s_window")
    lookahead = min(standstill_lookahead, n_steps)

    def cycle(carry, _, *, scene, ref_s_last):
        F = carry.x0_lon.shape[0]
        v_min = jnp.maximum(0.0, carry.velocity
                            - 0.125 * horizon * scene.veh.a_max)
        v_max = jnp.maximum(v_min + 5.0, carry.velocity + 2.0)
        low_vel = carry.velocity < low_vel_threshold

        if stopping:
            s_win = jnp.asarray(s_window, dtype)               # [F, 2]
            cl, ca, tl, gv = jax.vmap(
                grid_ops.stopping_candidates,
                in_axes=(0, 0, 0, 0, 0, None))(
                    carry.x0_lon, carry.x0_lat, s_win[:, 0], s_win[:, 1],
                    low_vel, static_grid)
            lon_lo, lon_hi = s_win[:, 0], s_win[:, 1]
        else:
            cl, ca, tl = jax.vmap(
                grid_ops.velocity_keeping_candidates,
                in_axes=(0, 0, 0, 0, 0, None))(
                    carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel,
                    static_grid)
            gv = jnp.ones(cl.shape[:2], dtype=bool)
            lon_lo, lon_hi = v_min, v_max

        def window(pose, valid, step):
            wp = jax.lax.dynamic_slice_in_dim(pose, step, T, axis=1)
            wv = jax.lax.dynamic_slice_in_dim(valid, step, T, axis=1)
            # dynamic_slice clamps: windows past the prediction span would
            # repeat stale poses — invalidate them explicitly
            abs_step = step + jnp.arange(T, dtype=jnp.int32)
            return wp, wv & (abs_step < t_full)[None, :]

        obs_pose_w, obs_valid_w = jax.vmap(window)(
            scene.obs_pose, scene.obs_valid, carry.time_step)

        poly_w = poly_valid_w = None
        if scene.poly_verts.shape[1] > 0:
            def poly_window(verts, valid, step):
                wv = jax.lax.dynamic_slice_in_dim(verts, step, T, axis=1)
                wl = jax.lax.dynamic_slice_in_dim(valid, step, T, axis=1)
                abs_step = step + jnp.arange(T, dtype=jnp.int32)
                return wv, wl & (abs_step < verts.shape[1])[None, :]

            poly_w, poly_valid_w = jax.vmap(poly_window)(
                scene.poly_verts, scene.poly_valid, carry.time_step)

        obstacles = ObstacleArrays(
            pose=obs_pose_w, half_ext=scene.obs_half, valid=obs_valid_w,
            radius=scene.obs_radius, poly_verts=poly_w,
            poly_valid=poly_valid_w)
        corridor = CorridorArrays(d_lo=scene.corridor_lo,
                                  d_hi=scene.corridor_hi)
        cost_params = cycle_ops.CostParams(
            w_a=jnp.full(F, w_a, dtype), desired_d=jnp.zeros(F, dtype),
            desired_speed=scene.desired_speed.astype(dtype),
            desired_s=jnp.zeros(F, dtype) if not stopping
            else jnp.asarray(desired_s, dtype))
        costs, kin_costs, _ = backend.fleet_scorer(obstacles)(
            cl, ca, tl, gv, scene.ref, scene.veh, obstacles, corridor,
            carry.orientation, cost_params, low_vel, ref_s_last, dt=dt,
            n_steps=n_steps, cost_structure=("default", True, stopping),
            constraint_flags=(True,) * 5)                  # [F, K] each

        best = jnp.argmin(costs, axis=1)                   # [F]
        best_cost = jnp.take_along_axis(costs, best[:, None], axis=1)[:, 0]
        found = jnp.isfinite(best_cost)
        # per-problem rejection statistics from the scorer's two cost rows
        # (facade-counter semantics: kinematic = inf in the stats row;
        # colliding = kinematically feasible but masked out)
        kin_inf = jnp.isinf(kin_costs)
        n_kin_infeasible = jnp.sum(kin_inf, axis=1).astype(jnp.int32)   # [F]
        n_colliding = jnp.sum(~kin_inf & jnp.isinf(costs),
                              axis=1).astype(jnp.int32)                 # [F]

        # re-roll ONLY the winners (K = 1 per problem) for the carry update
        def reroll(cl1, ca1, tl1, ref_f, veh_f, orient, lv):
            return kin_ops.rollout(cl1[None, :], ca1[None, :], tl1[None],
                                   ref_f, veh_f, orient, dt, n_steps, lv)
        take = lambda a: jnp.take_along_axis(
            a, best[:, None, None], axis=1)[:, 0]
        rollout = jax.vmap(reroll)(
            take(cl), take(ca),
            jnp.take_along_axis(tl, best[:, None], axis=1)[:, 0],
            scene.ref, scene.veh, carry.orientation, low_vel)

        r = replan_offset
        pick = lambda a: a[:, 0, r]
        new_lon = jnp.stack([pick(rollout.s), pick(rollout.s_dot),
                             pick(rollout.s_ddot)], axis=1)
        new_lat = jnp.stack([pick(rollout.d), pick(rollout.d_dot),
                             pick(rollout.d_ddot)], axis=1)

        # device-side standstill fallback (reactive_planner.py:638-653):
        # at v ~ 0 with nothing found (or a winner that stays slow at the
        # lookahead step) the member plans the standstill trajectory —
        # pose frozen, v = 0, cost 0 — and stays alive
        standstill = ((carry.velocity <= 0.05)
                      & (~found | (rollout.v[:, 0, lookahead] <= 0.05)))
        sel = lambda cond, a, b: jnp.where(
            cond.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
        new_lon = sel(standstill, carry.x0_lon, new_lon)
        new_lat = sel(standstill, carry.x0_lat, new_lat)
        new_theta = jnp.where(standstill, carry.orientation,
                              pick(rollout.theta_gl))
        new_v = jnp.where(standstill, 0.0, pick(rollout.v))
        new_x = jnp.where(standstill, carry.px, pick(rollout.x))
        new_y = jnp.where(standstill, carry.py, pick(rollout.y))
        best_cost = jnp.where(standstill, 0.0, best_cost)
        found = found | standstill

        step_alive = carry.alive & found
        keep = lambda new, old: sel(step_alive, new, old)
        new_carry = type(carry)(
            x0_lon=keep(new_lon, carry.x0_lon),
            x0_lat=keep(new_lat, carry.x0_lat),
            orientation=keep(new_theta, carry.orientation),
            velocity=keep(new_v, carry.velocity),
            time_step=jnp.where(step_alive, carry.time_step + r,
                                carry.time_step),
            alive=step_alive,
            kappa=keep(jnp.where(standstill, carry.kappa,
                                 pick(rollout.kappa_gl)), carry.kappa),
            px=keep(new_x, carry.px),
            py=keep(new_y, carry.py))
        # dead members (incl. pad_fleet padding) drop out of the aggregates
        n_success = jnp.sum(step_alive.astype(jnp.int32))
        cost_sum = jnp.sum(jnp.where(step_alive, best_cost, 0.0))
        n_found = jnp.maximum(jnp.sum(step_alive.astype(jnp.int32)), 1)
        if mesh is not None:
            n_success = jax.lax.psum(n_success, FLEET_AXIS)
            cost_sum = jax.lax.psum(cost_sum, FLEET_AXIS)
            n_found = jnp.maximum(jax.lax.psum(
                jnp.sum(step_alive.astype(jnp.int32)), FLEET_AXIS), 1)
        metrics = (step_alive, jnp.where(step_alive, best_cost, jnp.inf),
                   new_x, new_y,
                   n_success, cost_sum / n_found,
                   n_kin_infeasible, n_colliding,
                   new_theta, new_v)
        return new_carry, metrics

    def local_scan(carry, scene, ref_s_last):
        body = functools.partial(cycle, scene=scene, ref_s_last=ref_s_last)
        return jax.lax.scan(body, carry, None, length=n_cycles)

    if mesh is None:
        raw = jax.jit(lambda carry: local_scan(carry, scene, ref_s_last))
    else:
        f = P(FLEET_AXIS)
        from commonroad_rp_jax.parallel.fleet import FleetCarry, FleetScene
        from commonroad_rp_jax.ops import frenet as frenet_ops
        carry_spec = FleetCarry(*([f] * 9))
        scene_spec = FleetScene(
            ref=frenet_ops.RefPathTables(*([f] * 8)),
            obs_pose=f, obs_half=f, obs_valid=f, obs_radius=f,
            poly_verts=f, poly_valid=f,
            corridor_lo=f, corridor_hi=f, desired_speed=f,
            veh=kin_ops.VehicleArrays(*([f] * 8)))
        metrics_spec = (P(None, FLEET_AXIS), P(None, FLEET_AXIS),
                        P(None, FLEET_AXIS), P(None, FLEET_AXIS), P(None),
                        P(None), P(None, FLEET_AXIS), P(None, FLEET_AXIS),
                        P(None, FLEET_AXIS), P(None, FLEET_AXIS))
        sharded = shard_map(
            local_scan, mesh=mesh,
            in_specs=(carry_spec, scene_spec, f),
            out_specs=(carry_spec, metrics_spec),
            check_vma=False)
        raw = jax.jit(lambda carry: sharded(carry, scene, ref_s_last))

    def run(carry):
        # float32 scan: x64-off must wrap the CALL (the context inside the
        # traced body does not take effect)
        with jax.enable_x64(False):
            return raw(carry)

    # the jitted scan itself, for ahead-of-time lowering (trace it with
    # x64 off, as ``run`` does)
    run.jitted = raw
    return run


class FacadeScanCarry(NamedTuple):
    """Carry of the facade replanning scan (mirror of the planner's
    per-cycle state: curvilinear x0, pose, liveness).

    ``kappa``/``px``/``py`` carry the current curvature (tan(steering)/L)
    and Cartesian rear-axle position so the device-side standstill fallback
    (reactive_planner.py:667-713) can emit the host's exact trajectory
    arrays without a round-trip."""

    x0_lon: jnp.ndarray          # [3]
    x0_lat: jnp.ndarray          # [3]
    orientation: jnp.ndarray     # scalar
    velocity: jnp.ndarray        # scalar
    time_step: jnp.ndarray       # scalar int32
    alive: jnp.ndarray           # scalar bool
    kappa: jnp.ndarray           # scalar: current curvature tan(delta)/L
    px: jnp.ndarray              # scalar: cartesian x (rear axle)
    py: jnp.ndarray              # scalar: cartesian y (rear axle)


def make_facade_replanning_scan(ref: RefPathTables,
                                corridor: CorridorArrays,
                                obstacles_full: ObstacleArrays,
                                veh: kin_ops.VehicleArrays,
                                static_grids, dt: float, n_steps: int,
                                replan_offset: int,
                                low_vel_threshold: float, horizon: float,
                                desired_speed: float,
                                w_a: float, desired_d: float,
                                constraint_flags: tuple, n_cycles: int,
                                longitudinal_mode: str = "velocity_keeping",
                                desired_s: float | None = None,
                                s_window: tuple | None = None,
                                standstill_lookahead: int = 10,
                                boundary=None,
                                continuous: bool = False,
                                corridor_grids: tuple | None = None):
    """Device-resident facade loop: ``n_cycles`` of fused level-escalated
    planning cycles in ONE dispatch (``ReactivePlanner.plan_scan``).

    Each scan step regenerates every sampling level's candidate grid on
    device around the carried state (set_desired_velocity semantics,
    reactive_planner.py:329-335), scores the level union with the fused
    scorer, selects the first-found level's winner
    (``cycle.select_across_levels``), re-rolls only the winner, and records
    its first ``replan_offset`` states — the reference driver's cyclic
    replanning loop (run_planner.py:61-107) without a single host
    round-trip between cycles.

    The host's ``np.unique`` d-grid union (sampling.py:226) is reproduced by
    masking the appended current-offset sample ``goal_valid=False`` whenever
    it duplicates a base grid value; ordering differences against the host
    bundle only matter on exact cost ties (doc/conformance.md divergence 1).

    Longitudinal modes (reference sampling.py:253-266):
      * ``velocity_keeping`` — quartic lon toward a velocity window derived
        from the carried speed each cycle (set_desired_velocity semantics).
      * ``stopping`` — quintic lon toward stop positions sampled from the
        static ``s_window`` (absolute arclengths, set_desired_lon_position
        semantics); ``desired_s`` adds the stopping cost term and
        goal-behind candidates are masked (filter_goals_behind,
        trajectories.py:545-550).

    Standstill fallback ON DEVICE (reactive_planner.py:638-653, :667-713):
    when the carried velocity is <= 0.05 and either no candidate survived or
    the winner's speed at ``standstill_lookahead`` is <= 0.05, the cycle
    emits the host's exact standstill arrays (position/orientation frozen,
    v = 0, a[1] = -v0/dt, kappa from the carried steering curvature, cost 0)
    as a ``where``-branch and the scan continues instead of freezing.

    Returns ``run(carry) -> (carry, metrics)`` with metrics =
    (found [C], best_cost [C], n_inf_kin [C], n_coll [C],
    states [C, 14, replan_offset + 1] — CANDIDATE_FIELDS rows for offsets
    0..replan_offset of each cycle's winner).
    """
    from commonroad_rp_jax.ops.cycle import CANDIDATE_FIELDS

    dtype = jnp.float32
    T = n_steps + 1
    n_levels = len(corridor_grids) if corridor_grids is not None \
        else len(static_grids)
    M = obstacles_full.pose.shape[0]
    pose_all = obstacles_full.pose.astype(dtype)
    half_all = obstacles_full.half_ext.astype(dtype)
    valid_all = obstacles_full.valid
    radius_all = None if obstacles_full.radius is None \
        else obstacles_full.radius.astype(dtype)
    poly_all = None if obstacles_full.poly_verts is None \
        else obstacles_full.poly_verts.astype(dtype)
    poly_valid_all = obstacles_full.poly_valid
    t_full = pose_all.shape[1] if M else T
    if poly_all is not None:
        t_full = max(t_full, poly_all.shape[1])

    # static union layout: per-level sizes + appended-d-sample positions
    # (corridor mode: CorridorGrid lattices replace the static grids;
    # CorridorSampling has no appended-d union, reference sampling.py:340)
    if corridor_grids is not None:
        if longitudinal_mode != "velocity_keeping":
            raise ValueError("corridor sampling: velocity_keeping only "
                             "(reference sampling.py:340-397)")
        sizes = [cg.size for cg in corridor_grids]
    else:
        sizes = []
        appended = []
        for g in static_grids:
            nd1 = len(g.d_values) + 1
            k_l = len(g.t_values) * g.n_lon * nd1
            sizes.append(k_l)
            appended.append((np.arange(k_l) % nd1) == nd1 - 1)
    level_ids = jnp.asarray(np.concatenate(
        [np.full(k, j, np.int32) for j, k in enumerate(sizes)]))

    veh32 = cycle_ops.as_float32(veh)
    ref32 = cycle_ops.as_float32(ref)
    corridor32 = cycle_ops.as_float32(corridor)

    stopping = longitudinal_mode == "stopping"
    if stopping and (desired_s is None or s_window is None):
        raise ValueError("stopping mode requires desired_s and s_window")

    # Lazy exact refinement (reference reactive_planner.py:1013-1063): the
    # scorer's dense mask covers kinematics + discrete obstacles (+corridor);
    # the EXPENSIVE exact modes — 'segments' road boundary SAT and the
    # continuous swept-OBB pass — run per WINNER inside a while_loop,
    # masking a colliding winner to +inf and re-selecting, exactly the
    # reference's sorted lazy iteration (a visited-and-rejected candidate is
    # precisely one that is cheaper than the final winner and collides).
    refine_segments = boundary is not None and boundary.segments.shape[0] > 0
    refine = refine_segments or continuous
    if refine_segments:
        bound32 = BoundaryArrays(
            segments=jnp.asarray(boundary.segments, dtype),
            valid=jnp.asarray(boundary.valid))
        empty_obs = ObstacleArrays(pose=jnp.zeros((0, T, 3), dtype),
                                   half_ext=jnp.zeros((0, 2), dtype),
                                   valid=jnp.zeros((0, T), dtype=bool))

    def cycle(carry: FacadeScanCarry, _, ds=None):
        # ``ds`` is the TRACED desired speed (run(carry, desired_speed=...))
        # so velocity-tracking missions can vary the target per dispatch
        # without retracing the scan program
        if ds is None:
            ds = jnp.asarray(desired_speed, dtype)
        v_min = jnp.maximum(0.0, carry.velocity
                            - 0.125 * horizon * veh32.a_max)
        v_max = jnp.maximum(v_min + 5.0, carry.velocity + 2.0)
        low_vel = carry.velocity < low_vel_threshold

        cls, cas, tls, gvs = [], [], [], []
        if corridor_grids is not None:
            for cg in corridor_grids:
                cl, ca, tl, gv_l = grid_ops.corridor_candidates(
                    carry.x0_lon, carry.x0_lat, cg)
                cls.append(cl)
                cas.append(ca)
                tls.append(tl)
                gvs.append(gv_l)
        else:
            for g, app in zip(static_grids, appended):
                if stopping:
                    cl, ca, tl, gv_goal = grid_ops.stopping_candidates(
                        carry.x0_lon, carry.x0_lat,
                        jnp.asarray(s_window[0], dtype),
                        jnp.asarray(s_window[1], dtype), low_vel, g)
                else:
                    cl, ca, tl = grid_ops.velocity_keeping_candidates(
                        carry.x0_lon, carry.x0_lat, v_min, v_max, low_vel, g)
                    gv_goal = True
                dup = jnp.any(
                    jnp.asarray(g.d_values, dtype) == carry.x0_lat[0])
                gvs.append(~(jnp.asarray(app) & dup) & gv_goal)
                cls.append(cl)
                cas.append(ca)
                tls.append(tl)
        cl = jnp.concatenate(cls)
        ca = jnp.concatenate(cas)
        tl = jnp.concatenate(tls)
        gv = jnp.concatenate(gvs)

        abs_step = carry.time_step + jnp.arange(T, dtype=jnp.int32)
        in_span = abs_step < t_full
        if M:
            window_pose = jax.lax.dynamic_slice_in_dim(
                pose_all, carry.time_step, T, axis=1)
            window_valid = jax.lax.dynamic_slice_in_dim(
                valid_all, carry.time_step, T, axis=1)
            window_valid = window_valid & in_span[None, :]
        else:
            window_pose = jnp.zeros((0, T, 3), dtype)
            window_valid = jnp.zeros((0, T), dtype=bool)
        poly_w = poly_valid_w = None
        if poly_all is not None:
            poly_w = jax.lax.dynamic_slice_in_dim(
                poly_all, carry.time_step, T, axis=1)
            poly_valid_w = jax.lax.dynamic_slice_in_dim(
                poly_valid_all, carry.time_step, T, axis=1) & in_span[None, :]
        obstacles = ObstacleArrays(
            pose=window_pose,
            half_ext=half_all if M else jnp.zeros((0, 2), dtype),
            valid=window_valid, radius=radius_all,
            poly_verts=poly_w, poly_valid=poly_valid_w)

        cost_params = cycle_ops.CostParams(
            w_a=jnp.asarray(w_a, dtype), desired_d=jnp.asarray(desired_d, dtype),
            desired_speed=ds,
            desired_s=jnp.asarray(desired_s if stopping else 0.0, dtype))
        masked, kin, _ = backend.scorer(obstacles)(
            cl, ca, tl, gv, ref32, veh32, obstacles, corridor32,
            carry.orientation, cost_params, low_vel, dt=dt, n_steps=n_steps,
            cost_structure=("default", True, stopping),
            constraint_flags=constraint_flags)

        if refine:
            def check_winner(m):
                """(select, exact-check) one winner; True = must re-pick."""
                found_i, bi, *_ = cycle_ops.select_across_levels(
                    m, kin, gv, level_ids, n_levels)
                ro = kin_ops.rollout(
                    cl[bi][None, :], ca[bi][None, :], tl[bi][None],
                    ref32, veh32, carry.orientation, dt, n_steps, low_vel)
                colliding = jnp.zeros((1,), dtype=bool)
                if refine_segments:
                    colliding = colliding | collision_ops.check_collisions(
                        ro.x, ro.y, ro.theta_gl, empty_obs, bound32,
                        veh32.half_length, veh32.half_width,
                        veh32.wb_rear_axle)
                if continuous:
                    colliding = colliding | \
                        collision_ops.check_collisions_continuous(
                            ro.x, ro.y, ro.theta_gl, obstacles,
                            veh32.half_length, veh32.half_width,
                            veh32.wb_rear_axle)
                bad = found_i & colliding[0]
                m = jnp.where(bad & (jnp.arange(m.shape[0]) == bi),
                              jnp.inf, m)
                return m, bad

            def refine_body(state):
                m, _ = state
                return check_winner(m)

            masked, _ = jax.lax.while_loop(
                lambda state: state[1], refine_body, check_winner(masked))

        (found, best_idx, best_cost, _stat_level, n_inf_kin,
         n_coll) = cycle_ops.select_across_levels(masked, kin, gv,
                                                  level_ids, n_levels)

        # re-roll ONLY the winner for the recorded states + carry update
        cv, ck_v, ck, ckd, cy = constraint_flags
        rollout = kin_ops.rollout(
            cl[best_idx][None, :], ca[best_idx][None, :], tl[best_idx][None],
            ref32, veh32, carry.orientation, dt, n_steps, low_vel,
            check_velocity=cv, check_acceleration=ck_v, check_kappa=ck,
            check_kappa_dot=ckd, check_yaw_rate=cy)
        r = replan_offset
        states = jnp.stack([getattr(rollout, f)[0, :r + 1]
                            for f in CANDIDATE_FIELDS])     # [14, r+1]

        # device-side standstill fallback (reactive_planner.py:638-653):
        # engaged at v ~ 0 when nothing was found OR the winner stays slow
        # at the lookahead step — replaces the winner with the host's exact
        # standstill arrays (:667-713) at cost 0
        lookahead_v = rollout.v[0, standstill_lookahead]
        standstill = ((carry.velocity <= 0.05)
                      & (~found | (lookahead_v <= 0.05)))
        fill = lambda v: jnp.full((r + 1,), v, dtype)
        s0 = carry.x0_lon[0]
        idx0 = frenet_ops.interp_index(ref32, s0[None])
        theta_ref = frenet_ops.interpolate_angle_at(ref32, s0[None], idx0)[0]
        a_row = jnp.zeros((r + 1,), dtype).at[1].set(-carry.velocity / dt)
        ss_states = jnp.stack([
            fill(s0), fill(carry.x0_lon[1]), fill(carry.x0_lon[2]),
            fill(carry.x0_lat[0]), fill(carry.x0_lat[1]),
            fill(carry.x0_lat[2]),
            fill(carry.orientation - theta_ref),          # theta_cl
            fill(carry.px), fill(carry.py),
            fill(carry.orientation),
            jnp.zeros((r + 1,), dtype),                   # v = 0
            a_row,
            fill(carry.kappa),
            jnp.zeros((r + 1,), dtype)])                  # kappa_dot = 0
        states = jnp.where(standstill, ss_states, states)
        best_cost = jnp.where(standstill, dtype(0.0), best_cost)
        found = found | standstill

        step_alive = carry.alive & found
        keep = lambda new, old: jnp.where(step_alive, new, old)
        new_carry = FacadeScanCarry(
            x0_lon=keep(states[0:3, r], carry.x0_lon),
            x0_lat=keep(states[3:6, r], carry.x0_lat),
            orientation=keep(states[9, r], carry.orientation),
            velocity=keep(states[10, r], carry.velocity),
            time_step=jnp.where(step_alive, carry.time_step + r,
                                carry.time_step),
            alive=step_alive,
            kappa=keep(states[12, r], carry.kappa),
            px=keep(states[7, r], carry.px),
            py=keep(states[8, r], carry.py))
        metrics = (step_alive, best_cost, n_inf_kin, n_coll, states)
        return new_carry, metrics

    raw = jax.jit(
        lambda carry, ds: jax.lax.scan(
            functools.partial(cycle, ds=ds), carry, None, length=n_cycles))

    def run(carry: FacadeScanCarry, desired_speed_val: float | None = None):
        # float32 scan: x64-off must wrap the CALL
        ds = jnp.asarray(desired_speed if desired_speed_val is None
                         else desired_speed_val, jnp.float32)
        with jax.enable_x64(False):
            return raw(carry, ds)

    run.jitted = raw          # ahead-of-time lowering, as in the fleet scan
    return run
