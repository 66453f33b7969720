"""Sampling spaces: terminal-manifold grids -> batched candidate arrays.

Equivalent of the reference's sampling layer (reference:
commonroad_rp/sampling.py:28-408) with one structural change: instead of
producing one Python ``TrajectorySample`` object per candidate, a sampling
space emits a ``CandidateBatch`` — dense [K, 6] coefficient arrays plus
per-candidate metadata — which is the input of the single jitted cycle kernel
(SURVEY.md section 7: no Python object per candidate).

Grid semantics are replicated exactly: the n -> 2n-1 densification ladder
(sampling.py:80-99), the time grid construction (sampling.py:113-118), the
d-grid union with the current lateral offset (sampling.py:226), and the
low-velocity arclength reparameterization (sampling.py:229-238).  Candidate
order is deterministic: time-major, then longitudinal sample, then lateral
sample, each sorted ascending (the reference iterates Python sets, whose
order is unspecified — order only matters for exact-tie argmin).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration


# ---------------------------------------------------------------------------
# closed-form coefficients (host/numpy mirror of ops.polynomial)
# ---------------------------------------------------------------------------

def quintic_coeffs_np(x_0: np.ndarray, x_d: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Vectorized quintic boundary-value coefficients (see ops.polynomial)."""
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    p1, v1, a1 = x_d[..., 0], x_d[..., 1], x_d[..., 2]
    T2, T3, T4, T5 = T * T, T**3, T**4, T**5
    dp = p1 - (p0 + v0 * T + 0.5 * a0 * T2)
    dv = (v1 - (v0 + a0 * T)) * T
    da = (a1 - a0) * T2
    c3 = (10.0 * dp - 4.0 * dv + 0.5 * da) / T3
    c4 = (-15.0 * dp + 7.0 * dv - da) / T4
    c5 = (6.0 * dp - 3.0 * dv + 0.5 * da) / T5
    return np.stack([np.broadcast_to(p0, c3.shape), np.broadcast_to(v0, c3.shape),
                     np.broadcast_to(0.5 * a0, c3.shape), c3, c4, c5], axis=-1)


def quartic_coeffs_np(x_0: np.ndarray, v_d: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Vectorized quartic coefficients, terminal acceleration 0 (ops.polynomial)."""
    p0, v0, a0 = x_0[..., 0], x_0[..., 1], x_0[..., 2]
    T2, T3 = T * T, T**3
    dv = v_d - v0 - a0 * T
    da = -a0
    c3 = dv / T2 - da / (3.0 * T)
    c4 = da / (4.0 * T2) - dv / (2.0 * T3)
    zero = np.zeros_like(c3)
    return np.stack([np.broadcast_to(p0, c3.shape), np.broadcast_to(v0, c3.shape),
                     np.broadcast_to(0.5 * a0, c3.shape), c3, c4, zero], axis=-1)


def traj_length_steps(delta_tau: np.ndarray, dt: float) -> np.ndarray:
    """Number of evaluation steps: len(np.arange(0, round(dtau + dt, 5), dt))
    (reactive_planner.py:733).

    np.arange's float length is exactly ceil(stop / step) in double
    precision — including the cases where the division errs upward past an
    integer (e.g. dt = 0.3: 0.9 / 0.3 = 3.0000000000000004 -> 4 steps).  An
    earlier epsilon-guarded version (ceil(stop/dt - 1e-9)) silently produced
    one step FEWER there; found by the adversarial oracle audit
    (doc/conformance.md)."""
    stop = np.round(delta_tau + dt, 5)
    return np.ceil(stop / dt).astype(np.int32)


# ---------------------------------------------------------------------------
# sampling grids (1-D domains)
# ---------------------------------------------------------------------------

class Sampling(ABC):
    """Densification ladder of sample sets per level (sampling.py:28-69)."""

    def __init__(self, low: float, up: float, num_sampling_levels: int):
        assert np.greater_equal(up, low), \
            f"<Sampling>: upper bound {up} below lower bound {low}"
        assert isinstance(num_sampling_levels, int) and num_sampling_levels > 0
        self.low = low
        self.up = up
        self._n_samples = num_sampling_levels
        self._level_samples: Dict[int, np.ndarray] = {}
        self._sample()

    @abstractmethod
    def _sample(self):
        ...

    def samples_at_level(self, sampling_level: int = 0) -> np.ndarray:
        """Sorted, deduplicated samples of one level."""
        assert 0 <= sampling_level < self._n_samples, \
            f"<Sampling>: invalid level {sampling_level}"
        return self._level_samples[sampling_level]

    @property
    def num_sampling_levels(self) -> int:
        return self._n_samples


class VelocitySampling(Sampling):
    """3, 5, 9, 17, ... point linspace ladder (sampling.py:72-84)."""

    def _sample(self):
        n = 3
        for i in range(self._n_samples):
            self._level_samples[i] = np.unique(np.linspace(self.low, self.up, n))
            n = (n * 2) - 1


class PositionSampling(Sampling):
    """Same ladder for s/d position domains (sampling.py:87-99)."""

    def _sample(self):
        n = 3
        for i in range(self._n_samples):
            self._level_samples[i] = np.unique(np.linspace(self.low, self.up, n))
            n = (n * 2) - 1


class TimeSampling(Sampling):
    """Duration grid from t_min to the horizon (sampling.py:102-118)."""

    def __init__(self, low: float, up: float, num_sampling_levels: int, dt: float):
        self.dT = dt
        assert low >= 2 * dt, \
            "<TimeSampling>: t_min must be at least two planner time steps"
        super().__init__(low, up, num_sampling_levels)

    def _sample(self):
        for i in range(self._n_samples):
            step_size = int((1 / (i + 1)) / self.dT)
            samples = np.arange(self.low, round(self.up + self.dT, 2),
                                step_size * self.dT)
            limit = round(self.up + self.dT, 2)
            samples = samples[samples != limit]
            self._level_samples[i] = np.unique(samples)


# ---------------------------------------------------------------------------
# candidate batch
# ---------------------------------------------------------------------------

@dataclass
class CandidateBatch:
    """Dense candidate arrays for one sampling level (the bundle).

    Replaces the reference's List[TrajectorySample] / TrajectoryBundle
    (trajectories.py:335-558) with array-of-candidates form.
    """

    coeffs_lon: np.ndarray    # [K, 6]
    coeffs_lat: np.ndarray    # [K, 6]
    delta_tau: np.ndarray     # [K] candidate duration (time domain)
    delta_tau_lat: np.ndarray # [K] lateral parameter span (= delta_tau, or
                              #     travelled arclength in low-vel mode)
    traj_len: np.ndarray      # [K] int32 valid steps
    t_sample: np.ndarray      # [K] time sample
    lon_sample: np.ndarray    # [K] velocity (or position) sample
    d_sample: np.ndarray      # [K] lateral end offset sample
    # terminal longitudinal boundary state, for filter_goals_behind
    # (trajectories.py:545-550)
    lon_x0_pos: np.ndarray    # [K] initial s
    lon_xd_pos: np.ndarray    # [K] target s (NaN in velocity mode)

    @property
    def size(self) -> int:
        return len(self.delta_tau)


# ---------------------------------------------------------------------------
# sampling spaces
# ---------------------------------------------------------------------------

class SamplingSpace(ABC):
    """Holder of per-domain grids (sampling.py:121-175)."""

    def __init__(self, num_sampling_levels: int):
        self._num_sampling_levels = num_sampling_levels
        self.samples_t: Optional[TimeSampling] = None
        self.samples_d: Optional[PositionSampling] = None
        self.samples_v: Optional[VelocitySampling] = None
        self.samples_s: Optional[PositionSampling] = None

    @property
    def num_sampling_levels(self) -> int:
        return self._num_sampling_levels

    @abstractmethod
    def generate_trajectories_at_level(self, level_sampling: int,
                                       x_0_lon: np.ndarray, x_0_lat: np.ndarray,
                                       longitudinal_mode: str,
                                       low_vel_mode: bool) -> CandidateBatch:
        ...


class FixedIntervalSampling(SamplingSpace):
    """Fixed-interval terminal manifold (sampling.py:178-270), batched.

    The reference's triple loop t x lon x d with per-candidate polynomial
    construction becomes one broadcasted grid evaluation.
    """

    def __init__(self, config: ReactivePlannerConfiguration):
        super().__init__(config.sampling.num_sampling_levels)
        cs = config.sampling
        self.dt = config.planning.dt
        self.horizon = config.planning.dt * config.planning.time_steps_computation
        self.samples_t = TimeSampling(cs.t_min, self.horizon,
                                      self._num_sampling_levels, self.dt)
        self.samples_d = PositionSampling(cs.d_min, cs.d_max, self._num_sampling_levels)
        self.samples_v = VelocitySampling(cs.v_min, cs.v_max, self._num_sampling_levels)
        self.samples_s = PositionSampling(cs.s_min, cs.s_max, self._num_sampling_levels)

    def generate_trajectories_at_level(self, level_sampling: int,
                                       x_0_lon: np.ndarray, x_0_lat: np.ndarray,
                                       longitudinal_mode: str,
                                       low_vel_mode: bool) -> CandidateBatch:
        x_0_lon = np.asarray(x_0_lon, dtype=np.float64)
        x_0_lat = np.asarray(x_0_lat, dtype=np.float64)

        ts = self.samples_t.samples_at_level(level_sampling)
        if longitudinal_mode == "velocity_keeping":
            lons = self.samples_v.samples_at_level(level_sampling)
        elif longitudinal_mode == "stopping":
            lons = self.samples_s.samples_at_level(level_sampling)
        else:
            raise AttributeError(
                f"<FixedIntervalSampling>: invalid longitudinal mode {longitudinal_mode}")
        # d grid union with the current lateral offset (sampling.py:226)
        ds = np.unique(np.concatenate([self.samples_d.samples_at_level(level_sampling),
                                       [x_0_lat[0]]]))

        # full grid [Nt, Nl, Nd]
        t_g, lon_g, d_g = np.meshgrid(ts, lons, ds, indexing="ij")
        shape = t_g.shape

        # longitudinal polynomials depend on (t, lon) only
        if longitudinal_mode == "velocity_keeping":
            # quartic toward target velocity (sampling.py:253-258)
            coeffs_lon = quartic_coeffs_np(x_0_lon, lon_g, t_g)
            lon_xd_pos = np.full(shape, np.nan)
        else:
            # quintic toward target position, terminal v = a = 0 (:259-263)
            xd = np.stack([lon_g, np.zeros_like(lon_g), np.zeros_like(lon_g)], axis=-1)
            coeffs_lon = quintic_coeffs_np(x_0_lon, xd, t_g)
            lon_xd_pos = lon_g

        # lateral parameter span (sampling.py:229-238)
        if low_vel_mode:
            # travelled arclength over the candidate duration; fall back to t
            # when non-positive
            from commonroad_rp_jax.ops import polynomial as poly_ops
            import jax.numpy as jnp
            s_end = np.asarray(poly_ops.eval_position(jnp.asarray(coeffs_lon),
                                                      jnp.asarray(t_g)))
            s_goal = s_end - x_0_lon[0]
            delta_tau_lat = np.where(s_goal <= 0, t_g, s_goal)
        else:
            delta_tau_lat = t_g

        xd_lat = np.stack([d_g, np.zeros_like(d_g), np.zeros_like(d_g)], axis=-1)
        coeffs_lat = quintic_coeffs_np(x_0_lat, xd_lat, delta_tau_lat)

        flat = lambda arr: arr.reshape(-1, *arr.shape[3:])
        return CandidateBatch(
            coeffs_lon=flat(coeffs_lon), coeffs_lat=flat(coeffs_lat),
            delta_tau=flat(t_g), delta_tau_lat=flat(delta_tau_lat),
            traj_len=traj_length_steps(flat(t_g), self.dt),
            t_sample=flat(t_g), lon_sample=flat(lon_g), d_sample=flat(d_g),
            lon_x0_pos=np.full(flat(t_g).shape, x_0_lon[0]),
            lon_xd_pos=flat(lon_xd_pos))


class CorridorSampling(SamplingSpace):
    """Adaptive sampling inside externally supplied driving corridors.

    Equivalent of sampling.py:273-397 (CorridorSampling over CommonRoad-Reach
    corridors): per time step the corridor provides a longitudinal velocity
    interval and, per terminal position, lateral intervals.  The corridor is
    supplied as plain data (see ``DrivingCorridor``), not a commonroad-reach
    object.
    """

    def __init__(self, config: ReactivePlannerConfiguration):
        super().__init__(config.sampling.num_sampling_levels)
        self.dt = config.planning.dt
        self.horizon = config.planning.dt * config.planning.time_steps_computation
        self.samples_t = TimeSampling(config.sampling.t_min, self.horizon,
                                      self._num_sampling_levels, self.dt)
        self._corridor = None
        self._num_samples: Dict[int, int] = {}
        self.set_dict_number_of_samples()

    def set_dict_number_of_samples(self, n_min: int = 3,
                                   dict_level_to_num_samples: Dict[int, int] = None):
        """Configure samples per level (sampling.py:323-338): either the
        n -> 2n-1 ladder from ``n_min`` or an explicit per-level dict."""
        if dict_level_to_num_samples is not None:
            for level in range(self._num_sampling_levels):
                assert level in dict_level_to_num_samples, \
                    f"<CorridorSampling.set_dict_number_of_samples()>: missing level {level}"
            self._num_samples = dict(dict_level_to_num_samples)
            return
        n = n_min
        for i in range(self._num_sampling_levels):
            self._num_samples[i] = n
            n = (n * 2) - 1

    @property
    def driving_corridor(self):
        return self._corridor

    @driving_corridor.setter
    def driving_corridor(self, corridor):
        self._corridor = corridor

    def corridor_tables(self, level_sampling: int):
        """Pad the corridor's dict/list structure into dense arrays for the
        grid evaluation (and for the device scan path, ops.grid):
        (steps [Nt], v_bounds [Nt, 2], lat [Nt, I, 4], lat_valid [Nt, I])
        where ``lat`` columns are (s_lo, s_hi, d_lo, d_hi) in map order."""
        ts = self.samples_t.samples_at_level(level_sampling)
        steps = np.asarray([round(t / self.dt) + self._corridor.first_step
                            for t in ts], dtype=np.int64)
        v_bounds = np.asarray([self._corridor.velocity_interval(int(step))
                               for step in steps], dtype=np.float64)
        interval_lists = [self._corridor.lateral_interval_map.get(int(s), [])
                          for s in steps]
        n_iv = max((len(lst) for lst in interval_lists), default=0) or 1
        lat = np.zeros((len(ts), n_iv, 4), dtype=np.float64)
        lat[:, :, 0] = np.inf               # invalid rows never match s_end
        lat_valid = np.zeros((len(ts), n_iv), dtype=bool)
        for j, lst in enumerate(interval_lists):
            for i, row in enumerate(lst):
                lat[j, i] = row
                lat_valid[j, i] = True
        return np.asarray(ts, dtype=np.float64), v_bounds, lat, lat_valid

    def generate_trajectories_at_level(self, level_sampling: int,
                                       x_0_lon: np.ndarray, x_0_lat: np.ndarray,
                                       longitudinal_mode: str,
                                       low_vel_mode: bool) -> CandidateBatch:
        """Array-shaped corridor grid: one broadcasted evaluation over the
        (t, v, interval, d-slot) lattice, compressed by the validity mask —
        same candidate set and order as the reference's per-candidate triple
        loop (sampling.py:340-397), no Python loop over candidates.
        """
        if self._corridor is None:
            raise AttributeError("<CorridorSampling>: please set a driving corridor.")
        x_0_lon = np.asarray(x_0_lon, dtype=np.float64)
        x_0_lat = np.asarray(x_0_lat, dtype=np.float64)
        num = self._num_samples[level_sampling]

        ts, v_bounds, lat, lat_valid = self.corridor_tables(level_sampling)
        Nt = len(ts)
        # np.linspace's exact construction: start + i * ((stop-start)/div)
        # with the endpoint FORCED to stop (bitwise linspace parity)
        idx = np.arange(num, dtype=np.float64)

        def linspace_rows(lo, hi):
            step = (hi - lo) / (num - 1)
            rows = lo[..., None] + idx * step[..., None]
            rows[..., -1] = hi
            return rows

        # velocity lattice with np.unique's dedup (linspace rows are sorted;
        # duplicates appear only for degenerate windows)
        V = linspace_rows(v_bounds[:, 0], v_bounds[:, 1])            # [Nt, num]
        v_keep = np.ones_like(V, dtype=bool)
        v_keep[:, 1:] = V[:, 1:] != V[:, :-1]

        c_lon = quartic_coeffs_np(x_0_lon, V, ts[:, None])          # [Nt,num,6]
        # s_end = polyval(c_lon, t): Horner over the coefficient axis
        s_end = np.zeros_like(V)
        for k in range(5, -1, -1):
            s_end = s_end * ts[:, None] + c_lon[..., k]

        # interval selection: s_lo <= s_end <= s_hi per (t, v, interval)
        sel = (lat_valid[:, None, :]
               & (lat[:, None, :, 0] <= s_end[:, :, None])
               & (s_end[:, :, None] <= lat[:, None, :, 1]))         # [Nt,num,I]

        # lateral lattice: num linspace slots + one slot for the inserted 0
        # (np.unique(concat([samples, [0]])) == sorted slots with adjacent
        # dedup; the 0-slot participates only when d_lo < 0 < d_hi)
        d_lo, d_hi = lat[:, :, 2], lat[:, :, 3]                     # [Nt, I]
        D = linspace_rows(d_lo, d_hi)                               # [Nt,I,num]
        zero_slot = np.where((d_lo < 0) & (d_hi > 0), 0.0, np.inf)
        D_all = np.concatenate([D, zero_slot[:, :, None]], axis=-1)  # [Nt,I,num+1]
        order = np.argsort(D_all, axis=-1, kind="stable")
        D_sorted = np.take_along_axis(D_all, order, axis=-1)
        d_keep = np.ones_like(D_sorted, dtype=bool)
        d_keep[:, :, 1:] = D_sorted[:, :, 1:] != D_sorted[:, :, :-1]
        d_keep &= np.isfinite(D_sorted)

        # full lattice mask [Nt, num, I, num+1] -> flat candidate compression
        mask = (sel & v_keep[:, :, None])[..., None] & d_keep[:, None, :, :]
        t_g = np.broadcast_to(ts[:, None, None, None], mask.shape)
        v_g = np.broadcast_to(V[:, :, None, None], mask.shape)
        d_g = np.broadcast_to(D_sorted[:, None, :, :], mask.shape)
        c_lon_g = np.broadcast_to(c_lon[:, :, None, None, :],
                                  mask.shape + (6,))

        flat = mask.reshape(-1)
        t_flat = t_g.reshape(-1)[flat]
        v_flat = v_g.reshape(-1)[flat]
        d_flat = d_g.reshape(-1)[flat]
        c_lon_flat = c_lon_g.reshape(-1, 6)[flat]
        xd_lat = np.stack([d_flat, np.zeros_like(d_flat),
                           np.zeros_like(d_flat)], axis=-1)
        c_lat_flat = quintic_coeffs_np(x_0_lat, xd_lat, t_flat)

        return CandidateBatch(
            coeffs_lon=c_lon_flat, coeffs_lat=c_lat_flat,
            delta_tau=t_flat, delta_tau_lat=t_flat,
            traj_len=traj_length_steps(t_flat, self.dt),
            t_sample=t_flat, lon_sample=v_flat, d_sample=d_flat,
            lon_x0_pos=np.full(t_flat.shape, x_0_lon[0]),
            lon_xd_pos=np.full(t_flat.shape, np.nan))


@dataclass
class DrivingCorridor:
    """Plain-data driving corridor for CorridorSampling.

    Carrier of what the reference pulls from commonroad-reach connected sets
    (sampling.py:305-311, :370-387): per time step a longitudinal velocity
    interval and a function from terminal s-position to lateral intervals.
    """

    first_step: int
    velocity_intervals: Dict[int, tuple]              # step -> (v_lo, v_hi)
    lateral_interval_map: Dict[int, list]             # step -> [(s_lo, s_hi, d_lo, d_hi)]

    def velocity_interval(self, step: int) -> tuple:
        return self.velocity_intervals[step]

    def lateral_intervals(self, step: int, s_end: float) -> list:
        out = []
        for s_lo, s_hi, d_lo, d_hi in self.lateral_interval_map.get(step, []):
            if s_lo <= s_end <= s_hi:
                out.append((d_lo, d_hi))
        return out


def sampling_space_factory(config: ReactivePlannerConfiguration) -> SamplingSpace:
    """Select the sampling space (sampling.py:400-408)."""
    method = config.sampling.sampling_method
    if method == 1:
        return FixedIntervalSampling(config)
    if method == 2:
        return CorridorSampling(config)
    raise ValueError(f"Invalid sampling method {method}")
