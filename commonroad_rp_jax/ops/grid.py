"""Device-side terminal-manifold grid generation.

On-device counterpart of models.sampling (which generates grids on the host
with exact reference-set semantics for the conformance path).  The fleet/scan
execution path cannot round-trip to the host per cycle (SURVEY.md section 2.3:
no host round-trips in the replanning scan), so the grid — whose bounds depend
on the carried vehicle state via set_desired_velocity
(reference: reactive_planner.py:329-335) — is built on device.

Static per compilation: the time grid (depends only on t_min/horizon/level,
sampling.py:113-118), per-time-sample step counts, the base d grid, and the
sample counts.  Traced: the velocity window bounds and the current lateral
offset (the ``∪ {x_0_lat[0]}`` extra d sample, sampling.py:226).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.models.sampling import (PositionSampling, TimeSampling,
                                               traj_length_steps)
from commonroad_rp_jax.ops import polynomial as poly


class StaticGrid(NamedTuple):
    """Host-precomputed static grid components for one sampling level."""

    t_values: Tuple[float, ...]       # time samples
    traj_len: Tuple[int, ...]         # valid steps per time sample
    d_values: Tuple[float, ...]       # base lateral offsets
    n_lon: int                        # number of longitudinal samples

    @property
    def size(self) -> int:
        return len(self.t_values) * self.n_lon * (len(self.d_values) + 1)


def make_static_grid(level: int, t_min: float, horizon: float, dt: float,
                     d_min: float, d_max: float, num_levels: int) -> StaticGrid:
    """Precompute the static grid parts for a sampling level (host)."""
    ts = TimeSampling(t_min, horizon, num_levels, dt).samples_at_level(level)
    ds = PositionSampling(d_min, d_max, num_levels).samples_at_level(level)
    n = 3
    for _ in range(level):
        n = n * 2 - 1
    return StaticGrid(t_values=tuple(float(t) for t in ts),
                      traj_len=tuple(int(v) for v in traj_length_steps(ts, dt)),
                      d_values=tuple(float(d) for d in ds),
                      n_lon=n)


def velocity_keeping_candidates(x0_lon: jnp.ndarray, x0_lat: jnp.ndarray,
                                v_min: jnp.ndarray, v_max: jnp.ndarray,
                                low_vel: jnp.ndarray, grid: StaticGrid):
    """Build the full candidate batch for velocity-keeping mode on device.

    Returns (coeffs_lon [K, 6], coeffs_lat [K, 6], traj_len [K]) with
    K = Nt * Nv * (Nd + 1).  Mirrors FixedIntervalSampling's triple loop
    (sampling.py:218-242) as one broadcasted evaluation; the quartic/quintic
    coefficients are the closed forms of ops.polynomial.
    """
    dtype = x0_lon.dtype
    t_g = jnp.asarray(grid.t_values, dtype)                          # [Nt]
    d_base = jnp.asarray(grid.d_values, dtype)                       # [Nd]
    d_g = jnp.concatenate([d_base, x0_lat[0][None]])                 # [Nd+1]
    v_g = jnp.linspace(v_min, v_max, grid.n_lon, dtype=dtype)        # [Nv]

    T, V, D = jnp.meshgrid(t_g, v_g, d_g, indexing="ij")             # [Nt,Nv,Nd+1]
    shape = T.shape

    coeffs_lon = poly.quartic_coeffs(jnp.broadcast_to(x0_lon, shape + (3,)), V, T)

    # low-velocity mode: lateral parameter span = travelled arclength
    # (sampling.py:229-238), falling back to t when non-positive
    s_goal = poly.eval_position(coeffs_lon, T) - x0_lon[0]
    tau_lat = jnp.where(low_vel, jnp.where(s_goal <= 0, T, s_goal), T)

    xd_lat = jnp.stack([D, jnp.zeros_like(D), jnp.zeros_like(D)], axis=-1)
    coeffs_lat = poly.quintic_coeffs(jnp.broadcast_to(x0_lat, shape + (3,)),
                                     xd_lat, tau_lat)

    traj_len = jnp.broadcast_to(
        jnp.asarray(grid.traj_len, jnp.int32)[:, None, None], shape)
    return (coeffs_lon.reshape(-1, 6), coeffs_lat.reshape(-1, 6),
            traj_len.reshape(-1))


def stopping_candidates(x0_lon: jnp.ndarray, x0_lat: jnp.ndarray,
                        s_min: jnp.ndarray, s_max: jnp.ndarray,
                        low_vel: jnp.ndarray, grid: StaticGrid):
    """Stopping-mode candidate batch: quintic longitudinal polynomials toward
    sampled stop positions with terminal velocity/acceleration zero
    (sampling.py:259-263).  Also returns the goal-validity mask
    (filter_goals_behind, trajectories.py:545-550)."""
    dtype = x0_lon.dtype
    t_g = jnp.asarray(grid.t_values, dtype)
    d_base = jnp.asarray(grid.d_values, dtype)
    d_g = jnp.concatenate([d_base, x0_lat[0][None]])
    s_g = jnp.linspace(s_min, s_max, grid.n_lon, dtype=dtype)

    T, S, D = jnp.meshgrid(t_g, s_g, d_g, indexing="ij")
    shape = T.shape

    xd_lon = jnp.stack([S, jnp.zeros_like(S), jnp.zeros_like(S)], axis=-1)
    coeffs_lon = poly.quintic_coeffs(jnp.broadcast_to(x0_lon, shape + (3,)),
                                     xd_lon, T)

    s_goal = poly.eval_position(coeffs_lon, T) - x0_lon[0]
    tau_lat = jnp.where(low_vel, jnp.where(s_goal <= 0, T, s_goal), T)
    xd_lat = jnp.stack([D, jnp.zeros_like(D), jnp.zeros_like(D)], axis=-1)
    coeffs_lat = poly.quintic_coeffs(jnp.broadcast_to(x0_lat, shape + (3,)),
                                     xd_lat, tau_lat)

    traj_len = jnp.broadcast_to(
        jnp.asarray(grid.traj_len, jnp.int32)[:, None, None], shape)
    goal_valid = (x0_lon[0] < S).reshape(-1)
    return (coeffs_lon.reshape(-1, 6), coeffs_lat.reshape(-1, 6),
            traj_len.reshape(-1), goal_valid)


class CorridorGrid(NamedTuple):
    """Dense corridor lattice tables for one sampling level (device scan
    counterpart of models.sampling.CorridorSampling.corridor_tables).

    Static shapes; the candidate set is the full (t, v, interval, d-slot)
    lattice with a validity mask (the host path compresses the same mask;
    lattice enumeration order matches, so argmin tie-breaking agrees).
    """

    t_values: Tuple[float, ...]       # [Nt]
    traj_len: Tuple[int, ...]         # [Nt]
    num: int                          # samples per interval at this level
    v_bounds: jnp.ndarray             # [Nt, 2]
    lat: jnp.ndarray                  # [Nt, I, 4] (s_lo, s_hi, d_lo, d_hi)
    lat_valid: jnp.ndarray            # [Nt, I]

    @property
    def size(self) -> int:
        n_iv = self.lat.shape[1]
        return len(self.t_values) * self.num * n_iv * (self.num + 1)


def make_corridor_grid(sampling_space, level: int, dt: float) -> CorridorGrid:
    """CorridorGrid from a CorridorSampling space with its corridor set."""
    ts, v_bounds, lat, lat_valid = sampling_space.corridor_tables(level)
    return CorridorGrid(
        t_values=tuple(float(t) for t in ts),
        traj_len=tuple(int(v) for v in traj_length_steps(ts, dt)),
        num=int(sampling_space._num_samples[level]),
        v_bounds=jnp.asarray(v_bounds, jnp.float32),
        lat=jnp.asarray(lat, jnp.float32),
        lat_valid=jnp.asarray(lat_valid))


def corridor_candidates(x0_lon: jnp.ndarray, x0_lat: jnp.ndarray,
                        cg: CorridorGrid):
    """Corridor-mode candidate batch on device: the same broadcasted
    (t, v, interval, d-slot) lattice as the host path
    (models.sampling.CorridorSampling.generate_trajectories_at_level,
    reference sampling.py:340-397), kept DENSE with a goal_valid mask
    instead of host-side compression.

    Returns (coeffs_lon [K, 6], coeffs_lat [K, 6], traj_len [K],
    goal_valid [K]) with K = Nt * num * I * (num + 1).
    """
    dtype = x0_lon.dtype
    num = cg.num
    ts = jnp.asarray(cg.t_values, dtype)                          # [Nt]
    vb = cg.v_bounds.astype(dtype)
    lat = cg.lat.astype(dtype)
    idx = jnp.arange(num, dtype=dtype)

    def linspace_rows(lo, hi):
        # np.linspace's exact construction with the endpoint forced
        step = (hi - lo) / (num - 1)
        rows = lo[..., None] + idx * step[..., None]
        return rows.at[..., -1].set(hi)

    V = linspace_rows(vb[:, 0], vb[:, 1])                         # [Nt, num]
    v_keep = jnp.concatenate(
        [jnp.ones_like(V[:, :1], dtype=bool), V[:, 1:] != V[:, :-1]], axis=1)

    c_lon = poly.quartic_coeffs(
        jnp.broadcast_to(x0_lon, V.shape + (3,)), V, ts[:, None])  # [Nt,num,6]
    s_end = poly.eval_position(c_lon, jnp.broadcast_to(ts[:, None], V.shape))

    sel = (cg.lat_valid[:, None, :]
           & (lat[:, None, :, 0] <= s_end[:, :, None])
           & (s_end[:, :, None] <= lat[:, None, :, 1]))           # [Nt,num,I]

    d_lo, d_hi = lat[:, :, 2], lat[:, :, 3]                       # [Nt, I]
    D = linspace_rows(d_lo, d_hi)                                 # [Nt,I,num]
    zero_slot = jnp.where((d_lo < 0) & (d_hi > 0), 0.0, jnp.inf)
    D_all = jnp.concatenate([D, zero_slot[:, :, None]], axis=-1)
    D_sorted = jnp.sort(D_all, axis=-1)                           # [Nt,I,num+1]
    d_keep = jnp.concatenate(
        [jnp.ones_like(D_sorted[..., :1], dtype=bool),
         D_sorted[..., 1:] != D_sorted[..., :-1]], axis=-1)
    d_keep = d_keep & jnp.isfinite(D_sorted)
    # inf slots are masked out; zero them so lateral coefficients stay finite
    D_safe = jnp.where(jnp.isfinite(D_sorted), D_sorted, 0.0)

    mask = (sel & v_keep[:, :, None])[..., None] \
        & d_keep[:, None, :, :]                          # [Nt,num,I,num+1]
    shape = mask.shape
    T_g = jnp.broadcast_to(ts[:, None, None, None], shape)
    D_g = jnp.broadcast_to(D_safe[:, None, :, :], shape)
    c_lon_g = jnp.broadcast_to(c_lon[:, :, None, None, :], shape + (6,))

    # corridor sampling keeps tau_lat = t (host path, sampling.py:394)
    xd_lat = jnp.stack([D_g, jnp.zeros_like(D_g), jnp.zeros_like(D_g)],
                       axis=-1)
    c_lat = poly.quintic_coeffs(jnp.broadcast_to(x0_lat, shape + (3,)),
                                xd_lat, T_g)

    traj_len = jnp.broadcast_to(
        jnp.asarray(cg.traj_len, jnp.int32)[:, None, None, None], shape)
    return (c_lon_g.reshape(-1, 6), c_lat.reshape(-1, 6),
            traj_len.reshape(-1), mask.reshape(-1))
