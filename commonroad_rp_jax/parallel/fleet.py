"""Fleet planning: the replanning loop as a sharded device scan.

The production execution path (SURVEY.md sections 2.3 and 7.5): thousands of
independent planning problems replanned in lockstep, sharded over a device
mesh.  The entire cyclic replanning loop of the reference driver
(reference: run_planner.py:61-107) becomes ``lax.scan`` over cycles with
carry = (curvilinear state, pose, liveness) — no host round-trips.  The
per-cycle body regenerates the terminal-manifold grid on device around the
carried state (set_desired_velocity semantics, reactive_planner.py:329-335),
evaluates all candidates dense, and advances ``replanning_frequency`` steps
along the selected optimum (the driver's intermediate-step walk,
run_planner.py:94-107).

Sharding: 1-D mesh over the fleet axis via ``shard_map``; per-cycle fleet
aggregates (success counts, mean cost) are scalar ``psum`` reductions.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cost as cost_ops
from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.parallel.mesh import FLEET_AXIS


class FleetScene(NamedTuple):
    """Stacked per-problem scene tables (leading fleet axis F on every leaf)."""

    ref: frenet_ops.RefPathTables          # leaves [F, P, ...]
    obs_pose: jnp.ndarray                  # [F, M, T_scene, 3]
    obs_half: jnp.ndarray                  # [F, M, 2]
    obs_valid: jnp.ndarray                 # [F, M, T_scene]
    obs_radius: jnp.ndarray                # [F, M] disc radius (0 = OBB row)
    poly_verts: jnp.ndarray                # [F, Mp, T_scene, V, 2] (Mp may be 0)
    poly_valid: jnp.ndarray                # [F, Mp, T_scene]
    corridor_lo: jnp.ndarray               # [F, P] drivable band lower offset
    corridor_hi: jnp.ndarray               # [F, P] drivable band upper offset
    desired_speed: jnp.ndarray             # [F]
    veh: kin_ops.VehicleArrays             # leaves [F] (per-problem vehicles)


class FleetCarry(NamedTuple):
    """Scan carry: per-problem planner state between cycles.

    ``kappa``/``px``/``py`` (curvature tan(delta)/L and Cartesian rear-axle
    position) feed the fused-scorer fleet scan's device-side standstill fallback
    (reactive_planner.py:638-653); the XLA fleet path carries them through
    unchanged."""

    x0_lon: jnp.ndarray                    # [F, 3] (s, s_dot, s_ddot)
    x0_lat: jnp.ndarray                    # [F, 3] (d, d_dot, d_ddot)
    orientation: jnp.ndarray               # [F]
    velocity: jnp.ndarray                  # [F]
    time_step: jnp.ndarray                 # [F] int32
    alive: jnp.ndarray                     # [F] bool (False once planning fails)
    kappa: jnp.ndarray                     # [F] current curvature tan(delta)/L
    px: jnp.ndarray                        # [F] cartesian x (rear axle)
    py: jnp.ndarray                        # [F] cartesian y (rear axle)


class CycleMetrics(NamedTuple):
    """Per-cycle outputs stacked by the scan."""

    found: jnp.ndarray                     # [F] bool
    best_cost: jnp.ndarray                 # [F]
    x: jnp.ndarray                         # [F] selected next x position
    y: jnp.ndarray                         # [F]
    fleet_success: jnp.ndarray             # scalar: psum of found across fleet
    fleet_mean_cost: jnp.ndarray           # scalar


def _single_problem_cycle(carry_lon, carry_lat, orientation, velocity,
                          time_step, alive,
                          ref: frenet_ops.RefPathTables,
                          obs_pose, obs_half, obs_valid, obs_radius,
                          poly_verts, poly_valid,
                          corridor_lo, corridor_hi, desired_speed,
                          veh: kin_ops.VehicleArrays,
                          kappa=None, px=None, py=None,
                          *, static_grid: grid_ops.StaticGrid,
                          dt: float, n_steps: int, replan_offset: int,
                          low_vel_threshold: float, horizon: float,
                          standstill_lookahead: int = 10):
    """One planning cycle for ONE problem (vmapped over the fleet shard).

    With ``kappa``/``px``/``py`` given (the FleetCarry pose fields), the
    standstill fallback (reactive_planner.py:638-653) engages on device: at
    v ~ 0 with no feasible candidate (or a winner still slow at the
    lookahead step) the member freezes its pose at v = 0 / cost 0 and stays
    alive.  Without them (legacy callers) failure deadens the member."""
    dtype = carry_lon.dtype

    # velocity window (reactive_planner.py:332-334)
    v_min = jnp.maximum(0.0, velocity - 0.125 * horizon * veh.a_max)
    v_max = jnp.maximum(v_min + 5.0, velocity + 2.0)
    low_vel = velocity < low_vel_threshold

    coeffs_lon, coeffs_lat, traj_len = grid_ops.velocity_keeping_candidates(
        carry_lon, carry_lat, v_min, v_max, low_vel, static_grid)

    rollout = kin_ops.rollout(coeffs_lon, coeffs_lat, traj_len, ref, veh,
                              orientation, dt, n_steps, low_vel)
    costs = cost_ops.default_cost(rollout, w_a=jnp.asarray(5.0, dtype),
                                  desired_d=jnp.asarray(0.0, dtype),
                                  desired_speed=desired_speed)

    # obstacle window starting at the problem's current scenario step;
    # dynamic_slice clamps the start index, so windows past the prediction
    # span would repeat stale poses — invalidate those steps explicitly
    T = n_steps + 1
    window_pose = jax.lax.dynamic_slice_in_dim(obs_pose, time_step, T, axis=1)
    window_valid = jax.lax.dynamic_slice_in_dim(obs_valid, time_step, T, axis=1)
    abs_step = time_step + jnp.arange(T, dtype=jnp.int32)
    window_valid = window_valid & (abs_step < obs_pose.shape[1])[None, :]
    if poly_verts.shape[0] > 0:
        poly_w = jax.lax.dynamic_slice_in_dim(poly_verts, time_step, T, axis=1)
        poly_valid_w = jax.lax.dynamic_slice_in_dim(
            poly_valid, time_step, T, axis=1) & \
            (abs_step < poly_verts.shape[1])[None, :]
    else:
        poly_w = poly_valid_w = None
    obstacles = collision_ops.ObstacleArrays(pose=window_pose, half_ext=obs_half,
                                             valid=window_valid,
                                             radius=obs_radius,
                                             poly_verts=poly_w,
                                             poly_valid=poly_valid_w)
    collides = collision_ops.check_collisions(
        rollout.x, rollout.y, rollout.theta_gl, obstacles, None,
        veh.half_length, veh.half_width, veh.wb_rear_axle)
    corridor = collision_ops.CorridorArrays(d_lo=corridor_lo, d_hi=corridor_hi)
    collides = collides | collision_ops.check_corridor(
        rollout.s, rollout.d, rollout.theta_cl, ref.s, corridor,
        veh.half_length, veh.half_width, veh.wb_rear_axle)

    ok = rollout.feasible & ~collides
    masked = jnp.where(ok, costs, jnp.asarray(jnp.inf, dtype))
    best = jnp.argmin(masked)
    found = jnp.any(ok)

    # advance replan_offset steps along the optimum (run_planner.py:94-107;
    # curvilinear carry from the trajectory arrays as in run_planner.py:85)
    r = replan_offset
    new_lon = jnp.stack([rollout.s[best, r], rollout.s_dot[best, r],
                         rollout.s_ddot[best, r]])
    new_lat = jnp.stack([rollout.d[best, r], rollout.d_dot[best, r],
                         rollout.d_ddot[best, r]])
    new_orientation = rollout.theta_gl[best, r]
    new_velocity = rollout.v[best, r]
    new_x = rollout.x[best, r]
    new_y = rollout.y[best, r]
    new_kappa = rollout.kappa_gl[best, r]
    best_cost = masked[best]

    if kappa is not None:
        # device-side standstill fallback (reactive_planner.py:638-653)
        lookahead = min(standstill_lookahead, n_steps)
        standstill = ((velocity <= 0.05)
                      & (~found | (rollout.v[best, lookahead] <= 0.05)))
        new_lon = jnp.where(standstill, carry_lon, new_lon)
        new_lat = jnp.where(standstill, carry_lat, new_lat)
        new_orientation = jnp.where(standstill, orientation, new_orientation)
        new_velocity = jnp.where(standstill, 0.0, new_velocity)
        new_x = jnp.where(standstill, px, new_x)
        new_y = jnp.where(standstill, py, new_y)
        new_kappa = jnp.where(standstill, kappa, new_kappa)
        best_cost = jnp.where(standstill, 0.0, best_cost)
        found = found | standstill

    step_alive = alive & found
    keep = lambda new, old: jnp.where(step_alive, new, old)
    out_carry = (keep(new_lon, carry_lon), keep(new_lat, carry_lat),
                 keep(new_orientation, orientation),
                 keep(new_velocity, velocity),
                 jnp.where(step_alive, time_step + r, time_step),
                 step_alive,
                 keep(new_kappa, kappa) if kappa is not None else None,
                 keep(new_x, px) if px is not None else None,
                 keep(new_y, py) if py is not None else None)
    # dead members (incl. pad_fleet padding) report found=False / inf cost so
    # fleet aggregates count live problems only
    metrics = (step_alive, jnp.where(step_alive, best_cost, jnp.inf),
               new_x, new_y)
    return out_carry, metrics


def make_fleet_step(mesh: Mesh, veh: Optional[kin_ops.VehicleArrays],
                    static_grid: grid_ops.StaticGrid, dt: float, n_steps: int,
                    replan_offset: int, low_vel_threshold: float,
                    horizon: float):
    """Build the sharded one-cycle fleet step function.

    Returns step(carry: FleetCarry, scene: FleetScene) ->
    (FleetCarry, CycleMetrics), with the fleet axis sharded over ``mesh`` and
    fleet aggregates reduced with scalar psums.  Vehicle parameters come
    from scene.veh ([F]-shaped leaves: heterogeneous fleets); the ``veh``
    argument, if given, overrides them with one shared parameter set
    (backward compatibility).
    """
    cycle = functools.partial(
        _single_problem_cycle, static_grid=static_grid, dt=dt,
        n_steps=n_steps, replan_offset=replan_offset,
        low_vel_threshold=low_vel_threshold, horizon=horizon)
    vcycle = jax.vmap(cycle,
                      in_axes=(0,) * 16 + (None if veh is not None else 0,)
                      + (0, 0, 0))

    def local_step(carry: FleetCarry, scene: FleetScene):
        out_carry, (found, best_cost, x, y) = vcycle(
            carry.x0_lon, carry.x0_lat, carry.orientation, carry.velocity,
            carry.time_step, carry.alive, scene.ref, scene.obs_pose,
            scene.obs_half, scene.obs_valid, scene.obs_radius,
            scene.poly_verts, scene.poly_valid, scene.corridor_lo,
            scene.corridor_hi, scene.desired_speed,
            veh if veh is not None else scene.veh,
            carry.kappa, carry.px, carry.py)
        new_carry = FleetCarry(*out_carry)
        # fleet-level aggregates: scalar collectives across the mesh
        n_success = jax.lax.psum(jnp.sum(found.astype(jnp.int32)), FLEET_AXIS)
        finite = jnp.isfinite(best_cost)
        cost_sum = jax.lax.psum(jnp.sum(jnp.where(finite, best_cost, 0.0)),
                                FLEET_AXIS)
        n_finite = jax.lax.psum(jnp.sum(finite.astype(jnp.int32)), FLEET_AXIS)
        mean_cost = cost_sum / jnp.maximum(n_finite, 1)
        metrics = CycleMetrics(found=found, best_cost=best_cost, x=x, y=y,
                               fleet_success=n_success, fleet_mean_cost=mean_cost)
        return new_carry, metrics

    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(FleetCarry(*([P(FLEET_AXIS)] * 9)),
                  FleetScene(ref=frenet_ops.RefPathTables(
                      *([P(FLEET_AXIS)] * 8)),
                      obs_pose=P(FLEET_AXIS), obs_half=P(FLEET_AXIS),
                      obs_valid=P(FLEET_AXIS), obs_radius=P(FLEET_AXIS),
                      poly_verts=P(FLEET_AXIS), poly_valid=P(FLEET_AXIS),
                      corridor_lo=P(FLEET_AXIS),
                      corridor_hi=P(FLEET_AXIS),
                      desired_speed=P(FLEET_AXIS),
                      veh=kin_ops.VehicleArrays(*([P(FLEET_AXIS)] * 8)))),
        out_specs=(FleetCarry(*([P(FLEET_AXIS)] * 9)),
                   CycleMetrics(found=P(FLEET_AXIS), best_cost=P(FLEET_AXIS),
                                x=P(FLEET_AXIS), y=P(FLEET_AXIS),
                                fleet_success=P(), fleet_mean_cost=P())),
        check_vma=False)
    return sharded


def make_fleet_rollout(mesh: Mesh, veh: Optional[kin_ops.VehicleArrays],
                       static_grid: grid_ops.StaticGrid, dt: float,
                       n_steps: int, replan_offset: int,
                       low_vel_threshold: float, horizon: float,
                       n_cycles: int):
    """The full replanning loop: jitted scan of the sharded fleet step."""
    step = make_fleet_step(mesh, veh, static_grid, dt, n_steps, replan_offset,
                           low_vel_threshold, horizon)

    @jax.jit
    def run(carry: FleetCarry, scene: FleetScene):
        def body(c, _):
            return step(c, scene)
        return jax.lax.scan(body, carry, None, length=n_cycles)

    return run


# ---------------------------------------------------------------------------
# host-side fleet assembly
# ---------------------------------------------------------------------------

def pad_fleet(scene: FleetScene, carry: FleetCarry,
              n_devices: int) -> Tuple[FleetScene, FleetCarry, int]:
    """Pad the fleet axis to a multiple of the mesh size with DEAD members.

    ``shard_map`` requires F % n_devices == 0; uneven fleets are padded by
    repeating the final problem with ``alive=False`` — padded members freeze
    immediately and report found=False / +inf cost, so per-cycle aggregates
    (success count, mean cost) cover exactly the real fleet.  Returns
    (scene, carry, original_F); slice metrics back with [:original_F].
    """
    F = int(carry.alive.shape[0])
    pad = (-F) % n_devices
    if pad == 0:
        return scene, carry, F
    rep = lambda a: jnp.concatenate(
        [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0)
    scene_p = jax.tree.map(rep, scene)
    carry_p = FleetCarry(
        x0_lon=rep(carry.x0_lon), x0_lat=rep(carry.x0_lat),
        orientation=rep(carry.orientation), velocity=rep(carry.velocity),
        time_step=rep(carry.time_step),
        alive=jnp.concatenate([carry.alive,
                               jnp.zeros(pad, dtype=bool)]),
        kappa=rep(carry.kappa), px=rep(carry.px), py=rep(carry.py))
    return scene_p, carry_p, F


def build_fleet_scene(problems: List[dict], n_steps: int,
                      dtype=jnp.float32) -> Tuple[FleetScene, FleetCarry]:
    """Stack per-problem scene tables and initial carries with padding.

    ``problems`` entries carry: 'ref_tables' (RefPathTables), 'obstacles'
    (ObstacleArrays over the FULL scenario span + horizon padding),
    'boundary' (BoundaryArrays), 'x0_lon', 'x0_lat', 'orientation',
    'velocity', 'desired_speed', 'time_step'.
    """
    F = len(problems)
    P_max = max(p["ref_tables"].s.shape[0] for p in problems)
    M_max = max(max(p["obstacles"].pose.shape[0], 1) for p in problems)
    T_max = max(p["obstacles"].pose.shape[1] if p["obstacles"].pose.shape[0]
                else n_steps + 1 for p in problems)

    # IMPORTANT: all assembly is host-side numpy — eager jnp ops here would
    # each trigger a device compilation on slow-compile backends
    def pad_ref(tables: frenet_ops.RefPathTables):
        leaves = {f: np.asarray(getattr(tables, f))
                  for f in frenet_ops.RefPathTables._fields}
        n = leaves["s"].shape[0]
        pad = P_max - n
        if pad == 0:
            return leaves
        # extend the arclength monotonically so searchsorted stays correct;
        # padded vertices continue the final tangent direction
        extra_s = leaves["s"][-1] + np.arange(1, pad + 1) * 1e6
        extra_pts = leaves["points"][-1] + np.outer(
            np.arange(1, pad + 1) * 1e6, leaves["tangent"][-1])
        rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        return dict(points=np.concatenate([leaves["points"], extra_pts]),
                    s=np.concatenate([leaves["s"], extra_s]),
                    theta=rep(leaves["theta"]), curv=rep(leaves["curv"]),
                    curv_d=rep(leaves["curv_d"]), curv_dd=rep(leaves["curv_dd"]),
                    tangent=rep(leaves["tangent"]), normal=rep(leaves["normal"]))

    refs = [pad_ref(p["ref_tables"]) for p in problems]
    ref_stacked = frenet_ops.RefPathTables(
        *[jnp.asarray(np.stack([r[f] for r in refs]), dtype)
          for f in frenet_ops.RefPathTables._fields])

    def pad_obstacles(obs: collision_ops.ObstacleArrays):
        M = obs.pose.shape[0]
        T = obs.pose.shape[1] if M else 0
        pose = np.zeros((M_max, T_max, 3))
        half = np.ones((M_max, 2))
        valid = np.zeros((M_max, T_max), dtype=bool)
        radius = np.zeros(M_max)
        if M:
            pose[:M, :T] = np.asarray(obs.pose)
            half[:M] = np.asarray(obs.half_ext)
            valid[:M, :T] = np.asarray(obs.valid)
            if obs.radius is not None:
                radius[:M] = np.asarray(obs.radius)
        return pose, half, valid, radius

    obs = [pad_obstacles(p["obstacles"]) for p in problems]
    obs_pose = jnp.asarray(np.stack([o[0] for o in obs]), dtype)
    obs_half = jnp.asarray(np.stack([o[1] for o in obs]), dtype)
    obs_valid = jnp.asarray(np.stack([o[2] for o in obs]))
    obs_radius = jnp.asarray(np.stack([o[3] for o in obs]), dtype)

    # polygon group: pad every problem to (Mp_max, V_max) with invalid
    # pieces / repeated final vertices (degenerate edges never separate)
    Mp_max = max((p["obstacles"].poly_verts.shape[0]
                  if p["obstacles"].poly_verts is not None else 0)
                 for p in problems)
    V_max = max((p["obstacles"].poly_verts.shape[2]
                 if p["obstacles"].poly_verts is not None else 1)
                for p in problems)
    poly_verts = np.zeros((F, Mp_max, T_max, V_max, 2))
    poly_valid = np.zeros((F, Mp_max, T_max), dtype=bool)
    for f, p in enumerate(problems):
        pv = p["obstacles"].poly_verts
        if pv is None:
            continue
        pv = np.asarray(pv)
        mp, t_p, v_p = pv.shape[0], pv.shape[1], pv.shape[2]
        padded = np.concatenate(
            [pv, np.repeat(pv[:, :, -1:, :], V_max - v_p, axis=2)], axis=2)
        poly_verts[f, :mp, :t_p] = padded
        poly_valid[f, :mp, :t_p] = np.asarray(p["obstacles"].poly_valid)
    poly_verts = jnp.asarray(poly_verts, dtype)
    poly_valid = jnp.asarray(poly_valid)

    def pad_corridor(c: collision_ops.CorridorArrays):
        n = c.d_lo.shape[0]
        lo = np.full(P_max, -1e4)
        hi = np.full(P_max, 1e4)
        lo[:n] = np.asarray(c.d_lo)
        hi[:n] = np.asarray(c.d_hi)
        return lo, hi

    corrs = [pad_corridor(p["corridor"]) for p in problems]
    corridor_lo = jnp.asarray(np.stack([c[0] for c in corrs]), dtype)
    corridor_hi = jnp.asarray(np.stack([c[1] for c in corrs]), dtype)

    # per-problem vehicle parameter stacks (heterogeneous fleets); problems
    # without an explicit 'vehicle' entry default to the BMW 320i set
    from commonroad_rp_jax.utils.config import VehicleConfiguration

    veh_rows = []
    for p in problems:
        cfg = p.get("vehicle") or VehicleConfiguration()
        veh_rows.append([cfg.wheelbase, cfg.wb_rear_axle, cfg.a_max,
                         cfg.v_switch, np.tan(cfg.delta_max) / cfg.wheelbase,
                         cfg.v_delta_max, 0.5 * cfg.length, 0.5 * cfg.width])
    veh_mat = np.asarray(veh_rows, dtype=np.float64)
    veh_stacked = kin_ops.VehicleArrays(
        *[jnp.asarray(veh_mat[:, i], dtype) for i in range(8)])

    scene = FleetScene(
        ref=ref_stacked, obs_pose=obs_pose, obs_half=obs_half,
        obs_valid=obs_valid, obs_radius=obs_radius,
        poly_verts=poly_verts, poly_valid=poly_valid,
        corridor_lo=corridor_lo, corridor_hi=corridor_hi,
        desired_speed=jnp.asarray([p["desired_speed"] for p in problems], dtype),
        veh=veh_stacked)
    carry = FleetCarry(
        x0_lon=jnp.asarray(np.stack([p["x0_lon"] for p in problems]), dtype),
        x0_lat=jnp.asarray(np.stack([p["x0_lat"] for p in problems]), dtype),
        orientation=jnp.asarray([p["orientation"] for p in problems], dtype),
        velocity=jnp.asarray([p["velocity"] for p in problems], dtype),
        time_step=jnp.asarray([p.get("time_step", 0) for p in problems],
                              jnp.int32),
        alive=jnp.ones(F, dtype=bool),
        kappa=jnp.asarray([p.get("kappa", 0.0) for p in problems], dtype),
        px=jnp.asarray([p.get("px", 0.0) for p in problems], dtype),
        py=jnp.asarray([p.get("py", 0.0) for p in problems], dtype))
    return scene, carry


def problem_from_planner_setup(scenario, planning_problem, reference_path,
                               n_steps: int, horizon_pad: int,
                               dtype=jnp.float32, vehicle=None) -> dict:
    """Build one fleet-problem dict from scenario data (host, once).

    ``vehicle``: optional VehicleConfiguration for heterogeneous fleets
    (defaults to the BMW 320i parameter set, config.py:198).
    """
    from commonroad_rp_jax.models.state import ReactivePlannerState
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.coordinate_system import CoordinateSystem
    from commonroad_rp_jax.utils.general import retrieve_desired_velocity_from_pp

    veh_cfg = vehicle or VehicleConfiguration()
    co = CoordinateSystem(reference_path, dtype=dtype)
    x_0 = ReactivePlannerState.create_from_initial_state(
        planning_problem.initial_state, veh_cfg.wheelbase, veh_cfg.wb_rear_axle)

    low_vel = x_0.velocity < 4.0
    x0_lon, x0_lat = co.compute_initial_curvilinear_states(
        x_0.position, x_0.orientation, x_0.velocity, x_0.acceleration or 0.0,
        x_0.steering_angle or 0.0, veh_cfg.wheelbase, low_vel)
    x0_lon = np.asarray(x0_lon)
    x0_lat = np.asarray(x0_lat)

    # scenario span: last dynamic-obstacle prediction step + horizon padding
    last_step = 0
    for obstacle in scenario.dynamic_obstacles:
        if obstacle.trajectory:
            last_step = max(last_step, obstacle.trajectory[-1].time_step)
    span = last_step + horizon_pad + n_steps + 1
    obstacles = collision_ops.compile_obstacles(scenario, 0, span - 1, 1,
                                                dtype=dtype)
    boundary = collision_ops.compile_road_boundary(scenario, dtype=dtype)
    corridor = collision_ops.compile_corridor(boundary, co.tables, dtype=dtype)
    return dict(ref_tables=co.tables, obstacles=obstacles, boundary=boundary,
                corridor=corridor, vehicle=veh_cfg,
                x0_lon=x0_lon, x0_lat=x0_lat, orientation=x_0.orientation,
                velocity=x_0.velocity, time_step=0,
                desired_speed=retrieve_desired_velocity_from_pp(planning_problem),
                kappa=float(np.tan(x_0.steering_angle or 0.0)
                            / veh_cfg.wheelbase),
                px=float(x_0.position[0]), py=float(x_0.position[1]))
