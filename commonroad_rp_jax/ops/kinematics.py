"""Batched kinematic rollout, feasibility masks, and candidate extension.

Device-batched replacement for the reference's hot loop ``_check_kinematics``
(reference: commonroad_rp/reactive_planner.py:715-969): the reference walks
every candidate in a Python loop with per-step native-library calls; here the
entire bundle is one dense [K, T] array program — a short ``lax.scan`` over the
horizon (T = N+1 <= 61 steps) with the candidate axis vectorized, followed by
fully vectorized Frenet->Cartesian conversion and constant-acceleration
extension (``enlarge``) of short candidates.

Selection semantics replicate the reference exactly (SURVEY.md section 7
"hard parts"): same Werling Appendix-A formulas, same EPS clamps, same
constraint order for the infeasibility-reason statistics, same enlarge
arithmetic (trajectories.py:168-197, :302-332), including its quirks (the
curvilinear extension uses the zero-padded terminal acceleration, the
Cartesian one the repeated last acceleration).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.ops import polynomial as poly

# precision value (reactive_planner.py:49)
_EPS = 1e-5

# pycrccosy CurvilinearCoordinateSystem constructor defaults (the reference
# builds it bare at utils_coordinate_system.py:128): lateral projection-
# domain limit and the eps the C++ subtracts when building the domain polygon
PROJECTION_DOMAIN_LIMIT = 20.0
_CLCS_EPS = 0.1

# infeasibility reason codes (order = check order in _check_constraints,
# reactive_planner.py:971-1017; DOMAIN corresponds to the out-of-projection-
# domain rejection at :910-917 which is not part of the reason dict)
REASON_FEASIBLE = -1
REASON_VELOCITY = 0
REASON_KAPPA = 1
REASON_YAW_RATE = 2
REASON_KAPPA_DOT = 3
REASON_ACCELERATION = 4
REASON_DOMAIN = 5

REASON_NAMES = {
    REASON_VELOCITY: "velocity",
    REASON_KAPPA: "kappa",
    REASON_YAW_RATE: "yaw_rate",
    REASON_KAPPA_DOT: "kappa_dot",
    REASON_ACCELERATION: "acceleration",
}


class VehicleArrays(NamedTuple):
    """Traced vehicle constraint scalars (from utils.config.VehicleConfiguration)."""

    wheelbase: jnp.ndarray
    wb_rear_axle: jnp.ndarray
    a_max: jnp.ndarray
    v_switch: jnp.ndarray
    kappa_max: jnp.ndarray       # tan(delta_max) / wheelbase (config.py:222)
    v_delta_max: jnp.ndarray
    half_length: jnp.ndarray
    half_width: jnp.ndarray


class RolloutResult(NamedTuple):
    """Dense per-candidate trajectory arrays after rollout + enlarge.

    All state arrays are [K, T]; masks/stats are [K].
    """

    # curvilinear (CurviLinearSample fields, trajectories.py:200-213)
    s: jnp.ndarray
    s_dot: jnp.ndarray
    s_ddot: jnp.ndarray
    d: jnp.ndarray
    d_dot: jnp.ndarray
    d_ddot: jnp.ndarray
    theta_cl: jnp.ndarray
    # Cartesian (CartesianSample fields, trajectories.py:61-75)
    x: jnp.ndarray
    y: jnp.ndarray
    theta_gl: jnp.ndarray
    v: jnp.ndarray
    a: jnp.ndarray
    kappa_gl: jnp.ndarray
    kappa_dot: jnp.ndarray
    # feasibility
    feasible: jnp.ndarray        # [K] bool: kinematics + projection domain
    reason: jnp.ndarray          # [K] int32 reason code (REASON_*)


def rollout(coeffs_lon: jnp.ndarray,
            coeffs_lat: jnp.ndarray,
            traj_len: jnp.ndarray,
            ref: frenet_ops.RefPathTables,
            veh: VehicleArrays,
            x0_orientation: jnp.ndarray,
            dt: float,
            n_steps: int,
            low_vel_mode: bool,
            check_velocity: bool = True,
            check_acceleration: bool = True,
            check_kappa: bool = True,
            check_kappa_dot: bool = True,
            check_yaw_rate: bool = True) -> RolloutResult:
    """Evaluate, transform, constraint-check, and extend a candidate batch.

    Args:
      coeffs_lon/coeffs_lat: [K, 6] polynomial coefficients.
      traj_len: [K] int32 number of valid steps (len of the reference's
        per-candidate time array, reactive_planner.py:733-748).
      ref: reference-path tables.
      veh: vehicle constraint scalars.
      x0_orientation: scalar initial global orientation (used by the
        standstill branch of the orientation computation, :866).
      dt: planner step. n_steps: N; arrays span T = N+1 steps.
      low_vel_mode: lateral polynomials parameterized by arclength
        (reactive_planner.py:755-772).  May be a Python bool (folded at
        trace time) or a traced scalar bool (fleet/scan path, where the mode
        is data-dependent per cycle) — the kernel is branchless.
      check_*: which kinematic constraints are active
        (config.planning.constraints_to_check).
    """
    dtype = coeffs_lon.dtype
    K = coeffs_lon.shape[0]
    T = n_steps + 1
    low_vel = jnp.asarray(low_vel_mode, dtype=bool)
    t_vec = jnp.arange(T, dtype=dtype) * dt
    step_idx = jnp.arange(T, dtype=jnp.int32)

    # All internal math runs T-major ([T, K]): K is the large axis and must
    # occupy the 128-wide vector lanes; with T (= 21..61) minor, 5/6 of every
    # lane is padding.  The public API stays [K, T] (transposed at return).
    active = step_idx[:, None] < traj_len[None, :]          # [T, K]

    cl = coeffs_lon[None, :, :]
    # longitudinal rollout (reactive_planner.py:751-753), zero-padded beyond
    # traj_len like the reference's pre-allocated arrays (:740-745)
    tau_lon = t_vec[:, None]
    s = jnp.where(active, poly.eval_position(cl, tau_lon), 0.0)
    s_dot = jnp.where(active, poly.eval_velocity(cl, tau_lon), 0.0)
    s_ddot = jnp.where(active, poly.eval_acceleration(cl, tau_lon), 0.0)

    # lateral parameter: time, or travelled arclength in low-velocity mode
    # (reactive_planner.py:756-772)
    tau_lat = jnp.where(active,
                        jnp.where(low_vel, s - s[:1, :],
                                  jnp.broadcast_to(tau_lon, (T, K))),
                        0.0)
    ca = coeffs_lat[None, :, :]
    d = jnp.where(active, poly.eval_position(ca, tau_lat), 0.0)
    d_dot = jnp.where(active, poly.eval_velocity(ca, tau_lat), 0.0)
    d_ddot = jnp.where(active, poly.eval_acceleration(ca, tau_lat), 0.0)

    # near-zero velocity clamp (reactive_planner.py:776-777)
    s_dot = jnp.where(jnp.abs(s_dot) < _EPS, 0.0, s_dot)
    d_dot = jnp.where(jnp.abs(d_dot) < _EPS, 0.0, d_dot)

    # quick under-approximative pre-filter (reactive_planner.py:796-805);
    # acceleration is checked first, so it wins the reason when both trip
    pre_acc = jnp.any(jnp.abs(s_ddot) > veh.a_max, axis=0)
    pre_vel = jnp.any(s_dot < -_EPS, axis=0)
    prefiltered = pre_acc | pre_vel
    pre_reason = jnp.where(pre_acc, REASON_ACCELERATION, REASON_VELOCITY)

    # ---- per-step state transform, fully vectorized over [T, K] -----------
    # (the reference's per-step loop, reactive_planner.py:807-904; the only
    # sequential dependence — holding the previous global orientation while at
    # standstill in high-velocity mode, :866 — is expressed as a
    # last-moving-index cummax fill instead of a scan)
    moving = s_dot > 0.001
    sv_safe = jnp.where(moving, s_dot, 1.0)
    dp_high = jnp.where(moving, d_dot / sv_safe, 0.0)
    ddot = d_ddot - dp_high * s_ddot                        # Werling Eq. (A.8)
    dpp_high = jnp.where(moving, ddot / (sv_safe * sv_safe), 0.0)
    dp = jnp.where(low_vel, d_dot, dp_high)
    dpp = jnp.where(low_vel, d_ddot, dpp_high)

    idx = frenet_ops.interp_index(ref, s)
    tv = frenet_ops.lookup_interp_values(ref, idx)
    lam = (s - tv.s_lo) / (tv.s_hi - tv.s_lo)
    interp_theta = frenet_ops.wrap_two_pi(
        (tv.theta_hi - tv.theta_lo) * (s - tv.s_lo) / (tv.s_hi - tv.s_lo)
        + tv.theta_lo)

    # orientations (reactive_planner.py:841-873)
    theta_cl_move = jnp.arctan2(dp, 1.0)
    theta_gl_move = theta_cl_move + interp_theta
    use_move = moving | low_vel
    # standstill hold: theta_gl[i] = theta_gl_move at the last moving step
    # <= i, else the initial orientation
    last_move = jax.lax.cummax(
        jnp.where(use_move, step_idx[:, None], jnp.int32(-1)), axis=0)
    held = jnp.take_along_axis(theta_gl_move, jnp.maximum(last_move, 0), axis=0)
    theta_gl = jnp.where(last_move >= 0, held, x0_orientation)
    theta_cl = jnp.where(use_move, theta_cl_move, theta_gl - interp_theta)

    k_r = (tv.curv_hi - tv.curv_lo) * lam + tv.curv_lo
    k_r_d = (tv.curv_d_hi - tv.curv_d_lo) * lam + tv.curv_d_lo

    # global curvature, velocity, acceleration (Werling App. A;
    # reactive_planner.py:883-896, operation order preserved)
    one_krd = 1.0 - k_r * d
    cos_t = jnp.cos(theta_cl)
    tan_t = jnp.tan(theta_cl)
    kappa_gl = ((dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t *
                (cos_t / one_krd) ** 2 + (cos_t / one_krd) * k_r)
    v = s_dot * (one_krd / cos_t)
    a = (s_ddot * one_krd / cos_t + ((s_dot ** 2) / cos_t) *
         (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
          (k_r_d * d + k_r * dp)))

    # constraint violations, [T, K] each, in reference check order
    # (reactive_planner.py:971-1017)
    false_tk = jnp.zeros((T, K), dtype=bool)

    if check_velocity:
        vel_viol = v < -_EPS
    else:
        vel_viol = false_tk
    if check_kappa:
        kappa_viol = jnp.abs(kappa_gl) > veh.kappa_max
    else:
        kappa_viol = false_tk
    if check_yaw_rate:
        yaw_rate = jnp.concatenate(
            [jnp.zeros((1, K), dtype=dtype), jnp.diff(theta_gl, axis=0) / dt],
            axis=0)
        yaw_viol = jnp.abs(jnp.round(yaw_rate, 5)) > veh.kappa_max * v
    else:
        yaw_viol = false_tk
    if check_kappa_dot:
        steering_angle = jnp.arctan2(veh.wheelbase * kappa_gl, 1.0)
        kappa_dot_max = veh.v_delta_max / (veh.wheelbase *
                                           jnp.cos(steering_angle) ** 2)
        kd = jnp.concatenate(
            [jnp.zeros((1, K), dtype=dtype), jnp.diff(kappa_gl, axis=0) / dt],
            axis=0)
        kd_viol = jnp.abs(kd) > kappa_dot_max
    else:
        kd_viol = false_tk
    if check_acceleration:
        v_safe = jnp.where(v > veh.v_switch, v, 1.0)
        a_hi = jnp.where(v > veh.v_switch, veh.a_max * veh.v_switch / v_safe,
                         veh.a_max)
        acc_viol = (a < -veh.a_max) | (a > a_hi)
    else:
        acc_viol = false_tk

    # first failing (step, constraint) in lazy-iteration order: step-major,
    # then the fixed constraint order — encode as [T, 5, K] and take argmax
    viol_stack = jnp.stack([vel_viol, kappa_viol, yaw_viol, kd_viol, acc_viol],
                           axis=1) & active[:, None, :]
    viol_flat = viol_stack.reshape(T * 5, K)
    any_viol = jnp.any(viol_flat, axis=0)
    first_flat = jnp.argmax(viol_flat, axis=0)
    reason_codes = jnp.asarray([REASON_VELOCITY, REASON_KAPPA, REASON_YAW_RATE,
                                REASON_KAPPA_DOT, REASON_ACCELERATION],
                               dtype=jnp.int32)
    scan_reason = jnp.where(any_viol, reason_codes[first_flat % 5],
                            jnp.int32(REASON_FEASIBLE))
    scan_feasible = ~any_viol

    # zero-pad outputs beyond each candidate's valid span, matching the
    # reference's pre-allocated zero arrays (:781-791)
    pad = lambda arr: jnp.where(active, arr, 0.0)
    theta_cl, theta_gl, kappa_gl, v, a = (pad(arr) for arr in
                                          (theta_cl, theta_gl, kappa_gl, v, a))

    # ---- Frenet -> Cartesian (replaces per-point pycrccosy calls, :908-917)
    x, y_pos, in_domain = frenet_ops.to_cartesian(ref, s, d)
    x = jnp.where(active, x, 0.0)
    y_pos = jnp.where(active, y_pos, 0.0)
    # lateral projection-domain limits (the C++ CLCS shrinks the domain
    # where reference normals cross — 1 - kappa_r*d <= 0 — and caps it at
    # the default 20 m limit minus eps; pycrccosy constructor defaults used
    # at utils_coordinate_system.py:128): conversions there throw, making
    # the candidate domain-infeasible like convert_to_cartesian_coords
    # returning None (:908-917)
    in_domain = in_domain & (one_krd > 0.0) & \
        (jnp.abs(d) < PROJECTION_DOMAIN_LIMIT - _CLCS_EPS)
    domain_ok = jnp.all(in_domain | ~active, axis=0)

    # combine feasibility: prefilter -> per-step constraints -> domain
    reason = jnp.where(prefiltered, pre_reason, scan_reason)
    kin_feasible = ~prefiltered & scan_feasible
    reason = jnp.where(kin_feasible & ~domain_ok, REASON_DOMAIN, reason)
    feasible = kin_feasible & domain_ok

    # kappa_dot array: [0, diff(kappa_gl)] over the padded array, computed
    # BEFORE enlarge (reactive_planner.py:923)
    kappa_dot = jnp.concatenate(
        [jnp.zeros((1, K), dtype=dtype), jnp.diff(kappa_gl, axis=0)], axis=0)

    # ---- enlarge short candidates to N+1 steps --------------------------
    ext = ~active                                           # steps to fill
    last = traj_len - 1
    take_last = lambda arr: jnp.take_along_axis(arr, last[None, :], axis=0)
    t_rel = (step_idx[:, None] - last[None, :]).astype(dtype) * dt  # (j-last)*dt

    # Cartesian extension (trajectories.py:168-197)
    a_last = take_last(a)
    v_temp = take_last(v) + t_rel * a_last
    v_temp = v_temp * (v_temp >= 0)                         # :184
    theta_last = take_last(theta_gl)
    incr_x = jnp.where(ext, dt * v_temp * jnp.cos(theta_last), 0.0)
    incr_y = jnp.where(ext, dt * v_temp * jnp.sin(theta_last), 0.0)
    x = jnp.where(ext, take_last(x) + jnp.cumsum(incr_x, axis=0), x)
    y_pos = jnp.where(ext, take_last(y_pos) + jnp.cumsum(incr_y, axis=0), y_pos)
    v = jnp.where(ext, v_temp, v)
    a = jnp.where(ext, a_last, a)
    theta_gl = jnp.where(ext, theta_last, theta_gl)
    kappa_gl = jnp.where(ext, take_last(kappa_gl), kappa_gl)
    kappa_dot = jnp.where(ext, take_last(kappa_dot), kappa_dot)

    # curvilinear extension (trajectories.py:302-332); the padded terminal
    # s_ddot/d_ddot used for the velocity extension are zero (:313, :319),
    # so the extended velocities are constant (clamped at zero for s)
    s_dot_last = take_last(s_dot)
    s_dot_ext = s_dot_last * (s_dot_last >= 0)
    d_dot_last = take_last(d_dot)
    s = jnp.where(ext, take_last(s) + t_rel * s_dot_last, s)
    d = jnp.where(ext, take_last(d) + t_rel * d_dot_last, d)
    s_dot = jnp.where(ext, s_dot_ext, s_dot)
    d_dot = jnp.where(ext, d_dot_last, d_dot)
    s_ddot = jnp.where(ext, take_last(s_ddot), s_ddot)
    d_ddot = jnp.where(ext, take_last(d_ddot), d_ddot)
    theta_cl = jnp.where(ext, take_last(theta_cl), theta_cl)

    # back to the public [K, T] convention
    (s, s_dot, s_ddot, d, d_dot, d_ddot, theta_cl, x, y_pos, theta_gl, v, a,
     kappa_gl, kappa_dot) = (arr.T for arr in
                             (s, s_dot, s_ddot, d, d_dot, d_ddot, theta_cl, x,
                              y_pos, theta_gl, v, a, kappa_gl, kappa_dot))

    return RolloutResult(s=s, s_dot=s_dot, s_ddot=s_ddot, d=d, d_dot=d_dot,
                         d_ddot=d_ddot, theta_cl=theta_cl, x=x, y=y_pos,
                         theta_gl=theta_gl, v=v, a=a, kappa_gl=kappa_gl,
                         kappa_dot=kappa_dot, feasible=feasible,
                         reason=reason)
