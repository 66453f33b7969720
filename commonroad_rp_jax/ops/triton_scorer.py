"""The fleet scorer as one Pallas kernel on the Triton route (NVIDIA GPU).

Same contract as :func:`ops.cycle.score_fleet` — three [F, K] rows (masked
costs, kinematic-feasible costs, first-failure reason codes) — written for
the GPU: the grid is (problem, block of candidates); each program walks the
horizon in a loop with the candidate states in registers, loads reference
table rows by index (a branchless binary search over the arclength column),
loops over the obstacles and writes only the three rows.  The XLA scorer
materialises ~40 [F, K, T] intermediates in device memory; this kernel keeps
them on chip.

The arithmetic follows ``kinematics.rollout``, ``cost.default_cost`` /
``fail_safe_cost``, ``collision.check_collisions`` (OBB and disc rows) and
``collision.check_corridor`` step by step, so results agree with the XLA
scorer to float32 rounding.  Polygon obstacle groups are not handled here:
:func:`supports` says whether a call is in scope.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from commonroad_rp_jax.ops import kinematics

_EPS = kinematics._EPS
_DOMAIN_D = kinematics.PROJECTION_DOMAIN_LIMIT - kinematics._CLCS_EPS

# reference-table columns
_S, _THETA, _CURV, _CURV_D, _PX, _PY, _TX, _TY, _NX, _NY, _DLO, _DHI = \
    range(12)
_N_TAB = 12
# per-problem scalars
(_WB, _WB_REAR, _A_MAX, _V_SWITCH, _KAPPA_MAX, _V_DELTA_MAX, _HALF_L,
 _HALF_W, _THETA0, _LOW_VEL, _W_A, _DES_D, _DES_V, _DES_S, _S_LAST) = range(15)
_N_SCAL = 16
_N_OBS = 8          # x, y, theta, half_len, half_wid, valid, radius, (pad)
# candidates per program and warps per program: the fastest of (128, 4),
# (64, 2), (256, 8), (128, 2), (64, 4) in the fleet scan at T=21 and T=61 on
# an H100 (PERF.md, PR 1)
_BLOCK_K = 128
_NUM_WARPS = 4


def supports(obstacles) -> bool:
    """Whether the kernel covers this obstacle set (no polygon group)."""
    return obstacles.poly_verts is None


def _poly(c, tau):
    """(p, p', p'') with the term order and power construction of
    ``ops.polynomial`` (c: six [BK] coefficient vectors)."""
    t2 = tau * tau
    t3 = t2 * tau
    t4 = t2 * t2
    t5 = t4 * tau
    p = c[0] + c[1] * tau + c[2] * t2 + c[3] * t3 + c[4] * t4 + c[5] * t5
    v = (c[1] + 2.0 * c[2] * tau + 3.0 * c[3] * t2 + 4.0 * c[4] * t3
         + 5.0 * c[5] * t4)
    a = 2.0 * c[2] + 6.0 * c[3] * tau + 12.0 * c[4] * t2 + 20.0 * c[5] * t3
    return p, v, a


def _round5(x):
    """``jnp.round(x, 5)`` (round half to even at 1e-5) for float32."""
    y = x * jnp.float32(1e5)
    f = jnp.floor(y)
    diff = y - f
    half_even = jnp.where(f - 2.0 * jnp.floor(0.5 * f) == 0.0, f, f + 1.0)
    r = jnp.where(diff > 0.5, f + 1.0, jnp.where(diff < 0.5, f, half_even))
    return r / jnp.float32(1e5)


def _kernel(cl_ref, ca_ref, tl_ref, gv_ref, tab_ref, scal_ref, obs_ref,
            masked_ref, kin_ref, reason_ref, *, n_steps, dt, n_rows,
            n_obs, flags, cost_structure):
    f = pl.program_id(0)
    kb = pl.program_id(1)
    cand = pl.ds(kb * _BLOCK_K, _BLOCK_K)
    f32 = jnp.float32
    T = n_steps + 1
    P = n_rows
    cv, ca_f, ck, ckd, cy = flags

    c_lon = [cl_ref[f, j, cand] for j in range(6)]
    c_lat = [ca_ref[f, j, cand] for j in range(6)]
    tl = tl_ref[f, cand]
    goal_ok = gv_ref[f, cand] > 0
    sc = lambda i: scal_ref[f, i]
    wheelbase, wb_rear = sc(_WB), sc(_WB_REAR)
    a_max, v_switch = sc(_A_MAX), sc(_V_SWITCH)
    kappa_max, v_delta_max = sc(_KAPPA_MAX), sc(_V_DELTA_MAX)
    half_l, half_w = sc(_HALF_L), sc(_HALF_W)
    theta0 = sc(_THETA0)
    low_vel = sc(_LOW_VEL) > 0.5
    w_a, des_d, des_v, des_s = sc(_W_A), sc(_DES_D), sc(_DES_V), sc(_DES_S)
    s_last_true = sc(_S_LAST)
    tab = lambda idx, col: tab_ref[f, idx, col]
    s_first = tab_ref[f, 0, _S]
    s_end = tab_ref[f, P - 1, _S]

    nbits = int(P).bit_length()

    def count_le(q):
        """searchsorted(table s, q, side='right'): table rows <= q."""
        lo = jnp.zeros(q.shape, jnp.int32)
        step = 1 << (nbits - 1)
        while step >= 1:
            probe = lo + step
            idx = jnp.minimum(probe, P) - 1
            lo = jnp.where((probe <= P) & (tab(idx, _S) <= q), probe, lo)
            step //= 2
        return lo

    zeros = jnp.zeros((_BLOCK_K,), f32)
    false = jnp.zeros((_BLOCK_K,), jnp.bool_)
    inf = jnp.full((_BLOCK_K,), jnp.inf, f32)
    s0 = c_lon[0]

    def step_fn(t, c):
        tf = t.astype(f32)
        active = t < tl
        tau = tf * f32(dt)
        s, s_dot, s_ddot = _poly(c_lon, tau)
        s = jnp.where(active, s, 0.0)
        s_dot = jnp.where(active, s_dot, 0.0)
        s_ddot = jnp.where(active, s_ddot, 0.0)
        tau_lat = jnp.where(active, jnp.where(low_vel, s - s0, tau), 0.0)
        d, d_dot, d_ddot = _poly(c_lat, tau_lat)
        d = jnp.where(active, d, 0.0)
        d_dot = jnp.where(active, d_dot, 0.0)
        d_ddot = jnp.where(active, d_ddot, 0.0)
        s_dot = jnp.where(jnp.abs(s_dot) < _EPS, 0.0, s_dot)
        d_dot = jnp.where(jnp.abs(d_dot) < _EPS, 0.0, d_dot)

        pre_acc = c["pre_acc"] | (jnp.abs(s_ddot) > a_max)
        pre_vel = c["pre_vel"] | (s_dot < -_EPS)

        # Werling transform (kinematics.rollout)
        moving = s_dot > 0.001
        sv_safe = jnp.where(moving, s_dot, 1.0)
        dp_high = jnp.where(moving, d_dot / sv_safe, 0.0)
        ddot = d_ddot - dp_high * s_ddot
        dpp_high = jnp.where(moving, ddot / (sv_safe * sv_safe), 0.0)
        dp = jnp.where(low_vel, d_dot, dp_high)
        dpp = jnp.where(low_vel, d_ddot, dpp_high)

        cnt = count_le(s)
        idx = jnp.where(s >= s_end, -1, cnt - 1)
        lo_i = jnp.where(idx < 0, idx + P, idx)
        hi_i = jnp.where(lo_i + 1 >= P, lo_i + 1 - P, lo_i + 1)
        s_lo, s_hi = tab(lo_i, _S), tab(hi_i, _S)
        th_lo, th_hi = tab(lo_i, _THETA), tab(hi_i, _THETA)
        lam = (s - s_lo) / (s_hi - s_lo)
        raw = (th_hi - th_lo) * (s - s_lo) / (s_hi - s_lo) + th_lo
        two_pi = f32(2.0 * np.pi)
        ratio = raw / two_pi
        interp_theta = raw - two_pi * jnp.where(ratio < 0, jnp.ceil(ratio),
                                                jnp.floor(ratio))

        theta_cl_move = jnp.arctan2(dp, jnp.ones_like(dp))
        theta_gl_move = theta_cl_move + interp_theta
        use_move = moving | low_vel
        held = jnp.where(use_move, theta_gl_move, c["held"])
        theta_gl = held
        theta_cl = jnp.where(use_move, theta_cl_move, theta_gl - interp_theta)

        k_r = (tab(hi_i, _CURV) - tab(lo_i, _CURV)) * lam + tab(lo_i, _CURV)
        k_r_d = (tab(hi_i, _CURV_D) - tab(lo_i, _CURV_D)) * lam \
            + tab(lo_i, _CURV_D)
        one_krd = 1.0 - k_r * d
        cos_t = jnp.cos(theta_cl)
        tan_t = jnp.tan(theta_cl)
        kappa_gl = ((dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t *
                    (cos_t / one_krd) * (cos_t / one_krd)
                    + (cos_t / one_krd) * k_r)
        v = s_dot * (one_krd / cos_t)
        a = (s_ddot * one_krd / cos_t + ((s_dot * s_dot) / cos_t) *
             (one_krd * tan_t * (kappa_gl * one_krd / cos_t - k_r) -
              (k_r_d * d + k_r * dp)))

        # constraint checks in reference order; first (step, rank) wins
        first = t == 0
        viol = [false] * 5
        if cv:
            viol[0] = v < -_EPS
        if ck:
            viol[1] = jnp.abs(kappa_gl) > kappa_max
        if cy:
            yaw = jnp.where(first, 0.0, (theta_gl - c["theta_prev"]) / dt)
            viol[2] = jnp.abs(_round5(yaw)) > kappa_max * v
        if ckd:
            steer = jnp.arctan2(wheelbase * kappa_gl, jnp.ones_like(kappa_gl))
            cs = jnp.cos(steer)
            kd_max = v_delta_max / (wheelbase * (cs * cs))
            kd = jnp.where(first, 0.0, (kappa_gl - c["kappa_prev"]) / dt)
            viol[3] = jnp.abs(kd) > kd_max
        if ca_f:
            v_safe = jnp.where(v > v_switch, v, 1.0)
            a_hi = jnp.where(v > v_switch, a_max * v_switch / v_safe, a_max)
            viol[4] = (a < -a_max) | (a > a_hi)
        rank = jnp.full((_BLOCK_K,), -1, jnp.int32)
        for r in range(4, -1, -1):
            rank = jnp.where(viol[r], r, rank)
        reason = jnp.where((c["reason"] < 0) & active & (rank >= 0), rank,
                           c["reason"])

        # Frenet -> Cartesian on the containing (clipped) segment
        seg = jnp.clip(cnt - 1, 0, P - 2)
        ds_seg = s - tab(seg, _S)
        x_raw = tab(seg, _PX) + ds_seg * tab(seg, _TX) + d * tab(seg, _NX)
        y_raw = tab(seg, _PY) + ds_seg * tab(seg, _TY) + d * tab(seg, _NY)
        in_dom = ((s >= s_first) & (s <= s_end) & (one_krd > 0.0)
                  & (jnp.abs(d) < _DOMAIN_D) & (s <= s_last_true))
        dom_bad = c["dom_bad"] | (active & ~in_dom)

        # last active values (enlarge source), padded outputs
        lv = lambda new, old: jnp.where(active, new, old)
        last = dict(a=lv(a, c["a_l"]), v=lv(v, c["v_l"]),
                    th=lv(theta_gl, c["th_l"]), x=lv(x_raw, c["x_l"]),
                    y=lv(y_raw, c["y_l"]), s=lv(s, c["s_l"]),
                    d=lv(d, c["d_l"]), sd=lv(s_dot, c["sd_l"]),
                    dd=lv(d_dot, c["dd_l"]), tc=lv(theta_cl, c["tc_l"]))
        # constant-acceleration extension past traj_len (trajectories.py
        # :168-197, :302-332)
        t_rel = (t - (tl - 1)).astype(f32) * f32(dt)
        v_temp = last["v"] + t_rel * last["a"]
        v_temp = v_temp * (v_temp >= 0).astype(f32)
        ext = ~active
        acc_x = c["acc_x"] + jnp.where(ext, dt * v_temp * jnp.cos(last["th"]),
                                       0.0)
        acc_y = c["acc_y"] + jnp.where(ext, dt * v_temp * jnp.sin(last["th"]),
                                       0.0)
        x_f = jnp.where(ext, last["x"] + acc_x, x_raw)
        y_f = jnp.where(ext, last["y"] + acc_y, y_raw)
        v_f = jnp.where(ext, v_temp, v)
        a_f = jnp.where(ext, last["a"], a)
        th_f = jnp.where(ext, last["th"], theta_gl)
        tc_f = jnp.where(ext, last["tc"], theta_cl)
        s_f = jnp.where(ext, last["s"] + t_rel * last["sd"], s)
        d_f = jnp.where(ext, last["d"] + t_rel * last["dd"], d)

        # cost terms (cost.default_cost / fail_safe_cost)
        if cost_structure[0] == "default":
            _, has_v, has_s = cost_structure
            wa = w_a
        else:
            has_v, has_s, wa = False, False, f32(1.0)
        cost = c["cost"] + (wa * a_f) * (wa * a_f)
        if has_v:
            ev = 5.0 * (v_f - des_v)
            cost = cost + ev * ev
            cost = cost + jnp.where(t == T - 1, 50.0 * (v_f - des_v)
                                    * (v_f - des_v), 0.0)
            cost = cost + jnp.where(t == T // 2, 100.0 * (v_f - des_v)
                                    * (v_f - des_v), 0.0)
        if has_s:
            es = 0.25 * (des_s - s_f)
            cost = cost + es * es
            es_t = 20.0 * (des_s - s_f)
            cost = cost + jnp.where(t == T - 1, es_t * es_t, 0.0)
        dd_ref = des_d if cost_structure[0] == "default" else f32(0.0)
        ed = 0.25 * (dd_ref - d_f)
        cost = cost + ed * ed
        ed_t = 20.0 * (dd_ref - d_f)
        cost = cost + jnp.where(t == T - 1, ed_t * ed_t, 0.0)
        eo = 0.25 * jnp.abs(tc_f)
        cost = cost + eo * eo
        eo_t = 5.0 * jnp.abs(tc_f)
        cost = cost + jnp.where(t == T - 1, eo_t * eo_t, 0.0)

        # corridor road boundary (collision.check_corridor), 3 probes
        ct, st = jnp.cos(tc_f), jnp.sin(tc_f)
        s_center = s_f + wb_rear * ct
        d_center = d_f + wb_rear * st
        lat_ext = half_w * jnp.abs(ct) + half_l * jnp.abs(st)
        lon_ext = half_l * jnp.abs(ct) + half_w * jnp.abs(st)
        hits = c["hits"]
        for off in (-1.0, 0.0, 1.0):
            q = jnp.clip(s_center + off * lon_ext, s_first, s_last_true)
            row = jnp.clip(count_le(q) - 1, 0, P - 1)
            hits = hits | (d_center + lat_ext > tab(row, _DHI)) \
                | (d_center - lat_ext < tab(row, _DLO))

        # obstacles: OBB SAT and exact disc rows (collision.check_collisions)
        if n_obs:
            e_cos, e_sin = jnp.cos(th_f), jnp.sin(th_f)
            ex = x_f + wb_rear * e_cos
            ey = y_f + wb_rear * e_sin

            def obs_fn(m, hit):
                o = lambda col: obs_ref[f, t, m, col]
                ohl, ohw = o(3), o(4)
                radius = o(6)
                o_cos, o_sin = jnp.cos(o(2)), jnp.sin(o(2))
                dx = o(0) - ex
                dy = o(1) - ey
                rel_cos = jnp.abs(e_cos * o_cos + e_sin * o_sin)
                rel_sin = jnp.abs(o_sin * e_cos - o_cos * e_sin)
                lx = jnp.abs(dx * e_cos + dy * e_sin)
                ly = jnp.abs(-dx * e_sin + dy * e_cos)
                sep = lx > half_l + ohl * rel_cos + ohw * rel_sin
                sep = sep | (ly > half_w + ohl * rel_sin + ohw * rel_cos)
                sep = sep | (jnp.abs(dx * o_cos + dy * o_sin)
                             > ohl + half_l * rel_cos + half_w * rel_sin)
                sep = sep | (jnp.abs(-dx * o_sin + dy * o_cos)
                             > ohw + half_l * rel_sin + half_w * rel_cos)
                qx = jnp.maximum(lx - half_l, 0.0)
                qy = jnp.maximum(ly - half_w, 0.0)
                disc = qx * qx + qy * qy <= radius * radius
                h = jnp.where(radius > 0.0, disc, ~sep)
                return hit | (h & (o(5) > 0.5))

            hits = lax.fori_loop(0, n_obs, obs_fn, hits)

        return dict(pre_acc=pre_acc, pre_vel=pre_vel, held=held,
                    theta_prev=theta_gl, kappa_prev=kappa_gl, reason=reason,
                    dom_bad=dom_bad, a_l=last["a"], v_l=last["v"],
                    th_l=last["th"], x_l=last["x"], y_l=last["y"],
                    s_l=last["s"], d_l=last["d"], sd_l=last["sd"],
                    dd_l=last["dd"], tc_l=last["tc"], acc_x=acc_x,
                    acc_y=acc_y, cost=cost, hits=hits)

    init = dict(pre_acc=false, pre_vel=false,
                held=jnp.full((_BLOCK_K,), theta0, f32), theta_prev=zeros,
                kappa_prev=zeros, reason=jnp.full((_BLOCK_K,), -1, jnp.int32),
                dom_bad=false, a_l=zeros, v_l=zeros, th_l=zeros, x_l=zeros,
                y_l=zeros, s_l=zeros, d_l=zeros, sd_l=zeros, dd_l=zeros,
                tc_l=zeros, acc_x=zeros, acc_y=zeros, cost=zeros, hits=false)
    c = lax.fori_loop(0, T, step_fn, init)

    prefiltered = c["pre_acc"] | c["pre_vel"]
    pre_reason = jnp.where(c["pre_acc"], kinematics.REASON_ACCELERATION,
                           kinematics.REASON_VELOCITY)
    reason = jnp.where(prefiltered, pre_reason, c["reason"])
    kin_ok = ~prefiltered & (c["reason"] < 0)
    reason = jnp.where(kin_ok & c["dom_bad"], kinematics.REASON_DOMAIN,
                       reason)
    feasible = kin_ok & ~c["dom_bad"] & goal_ok
    masked_ref[f, cand] = jnp.where(feasible & ~c["hits"], c["cost"], inf)
    kin_ref[f, cand] = jnp.where(feasible, c["cost"], inf)
    reason_ref[f, cand] = reason.astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("dt", "n_steps", "cost_structure", "constraint_flags",
                     "interpret"))
def score_fleet_triton(coeffs_lon, coeffs_lat, traj_len, goal_valid, ref,
                       veh, obstacles, corridor, x0_orientation, cost_params,
                       low_vel_mode, ref_s_last, *, dt: float, n_steps: int,
                       cost_structure: tuple, constraint_flags: tuple,
                       interpret: bool = False):
    """:func:`ops.cycle.score_fleet` as one Triton-route Pallas kernel.

    Same arguments (every leaf with a leading fleet axis F) and the same
    three [F, K] rows; obstacles must have no polygon group
    (:func:`supports`).  ``interpret=True`` runs the kernel body on the CPU (tests).
    """
    if not supports(obstacles):
        raise ValueError("triton scorer: polygon obstacle groups are not "
                         "supported")
    f32 = jnp.float32
    F, K = coeffs_lon.shape[:2]
    T = n_steps + 1
    K_pad = pl.cdiv(K, _BLOCK_K) * _BLOCK_K
    pad = K_pad - K
    cl = jnp.pad(jnp.swapaxes(coeffs_lon.astype(f32), 1, 2),
                 ((0, 0), (0, 0), (0, pad)))
    ca = jnp.pad(jnp.swapaxes(coeffs_lat.astype(f32), 1, 2),
                 ((0, 0), (0, 0), (0, pad)))
    tl = jnp.pad(traj_len.astype(jnp.int32), ((0, 0), (0, pad)),
                 constant_values=1)
    gv = jnp.pad(goal_valid.astype(jnp.int32), ((0, 0), (0, pad)))
    tab = jnp.stack([ref.s, ref.theta, ref.curv, ref.curv_d,
                     ref.points[..., 0], ref.points[..., 1],
                     ref.tangent[..., 0], ref.tangent[..., 1],
                     ref.normal[..., 0], ref.normal[..., 1],
                     corridor.d_lo, corridor.d_hi], axis=-1).astype(f32)
    P = tab.shape[1]
    full = lambda v: jnp.broadcast_to(jnp.asarray(v, f32), (F,))
    scal = jnp.stack([
        full(veh.wheelbase), full(veh.wb_rear_axle), full(veh.a_max),
        full(veh.v_switch), full(veh.kappa_max), full(veh.v_delta_max),
        full(veh.half_length), full(veh.half_width), full(x0_orientation),
        full(jnp.asarray(low_vel_mode).astype(f32)), full(cost_params.w_a),
        full(cost_params.desired_d), full(cost_params.desired_speed),
        full(cost_params.desired_s), full(ref_s_last), jnp.zeros((F,), f32)],
        axis=1)
    M = obstacles.pose.shape[1]
    if M:
        radius = obstacles.radius if obstacles.radius is not None \
            else jnp.zeros((F, M), f32)
        obs = jnp.concatenate([
            obstacles.pose.astype(f32),
            jnp.broadcast_to(obstacles.half_ext[:, :, None, :],
                             (F, M, T, 2)).astype(f32),
            obstacles.valid.astype(f32)[..., None],
            jnp.broadcast_to(radius[:, :, None, None], (F, M, T, 1))
            .astype(f32),
            jnp.zeros((F, M, T, 1), f32)], axis=-1)
        obs = jnp.swapaxes(obs, 1, 2)                        # [F, T, M, 8]
    else:
        obs = jnp.zeros((F, T, 1, _N_OBS), f32)

    kernel = functools.partial(
        _kernel, n_steps=n_steps, dt=dt, n_rows=P, n_obs=M,
        flags=tuple(bool(x) for x in constraint_flags),
        cost_structure=cost_structure)
    out_shape = (jax.ShapeDtypeStruct((F, K_pad), f32),
                 jax.ShapeDtypeStruct((F, K_pad), f32),
                 jax.ShapeDtypeStruct((F, K_pad), jnp.int32))
    masked, kin, reasons = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(F, K_pad // _BLOCK_K),
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        backend="triton", interpret=interpret, name="fleet_scorer",
    )(cl, ca, tl, gv, tab, scal, obs)
    return masked[:, :K], kin[:, :K], reasons[:, :K]


def score_candidates_triton(coeffs_lon, coeffs_lat, traj_len, goal_valid,
                            ref, veh, obstacles, corridor, x0_orientation,
                            cost_params, low_vel_mode, ref_s_last=None, *,
                            dt: float, n_steps: int, cost_structure: tuple,
                            constraint_flags: tuple, interpret: bool = False):
    """:func:`ops.cycle.score_candidates` through the kernel, as a fleet of
    one (``ref_s_last`` None: the table's last arclength)."""
    if ref_s_last is None:
        ref_s_last = ref.s[-1]
    one = lambda tree: jax.tree.map(lambda a: jnp.asarray(a)[None], tree)
    rows = score_fleet_triton(
        *one((coeffs_lon, coeffs_lat, traj_len, goal_valid, ref, veh,
              obstacles, corridor, x0_orientation, cost_params,
              low_vel_mode, ref_s_last)),
        dt=dt, n_steps=n_steps, cost_structure=cost_structure,
        constraint_flags=constraint_flags, interpret=interpret)
    return tuple(r[0] for r in rows)
