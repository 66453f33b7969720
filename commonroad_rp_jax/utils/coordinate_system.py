"""Curvilinear coordinate-system wrapper.

Equivalent of the reference's ``CoordinateSystem``
(reference: commonroad_rp/utility/utils_coordinate_system.py:86-178), which
wraps the C++ CLCS and precomputes reference state tables.  Here construction
performs the same host-side preprocessing (vertex dedup + cubic-spline
smoothing + table computation) and additionally compiles the device-resident
``RefPathTables`` consumed by the batched kernels.  Point conversions are
host-convenience wrappers over ``ops.frenet`` (numpy-backed, no device round
trip) — the hot path never calls them per point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.utils import geometry


class CoordinateSystem:

    def __init__(self, reference: Optional[np.ndarray] = None,
                 tables: Optional[frenet_ops.RefPathTables] = None,
                 smooth_reference: bool = True, dtype=None):
        import jax.numpy as jnp
        dtype = dtype or jnp.float64

        if tables is not None:
            self._tables = tables
            self._reference = np.asarray(tables.points, dtype=np.float64)
        else:
            assert reference is not None, \
                "<CoordinateSystem>: provide a reference path OR tables"
            # dedup -> smooth -> dedup (utils_coordinate_system.py:93-104)
            reference = geometry.remove_duplicate_vertices(
                np.asarray(reference, dtype=np.float64))
            if smooth_reference:
                reference = geometry.smooth_ref_path(reference)
                reference = geometry.remove_duplicate_vertices(reference)
            # the C++ CLCS extends the polyline beyond its ends; without a
            # front extension an initial rear-axle position before the
            # route start clamps to s = 0 and teleports the first planned
            # state (see geometry.extend_ref_path_front)
            reference = geometry.extend_ref_path_front(reference)
            self._reference = reference
            self._tables = frenet_ops.from_polyline(reference, dtype=dtype)

        # host mirrors of the state tables (:114-118)
        self._ref_pos = np.asarray(self._tables.s, dtype=np.float64)
        self._ref_theta = np.asarray(self._tables.theta, dtype=np.float64)
        self._ref_curv = np.asarray(self._tables.curv, dtype=np.float64)
        self._ref_curv_d = np.asarray(self._tables.curv_d, dtype=np.float64)
        self._ref_curv_dd = np.asarray(self._tables.curv_dd, dtype=np.float64)
        self._tangent = np.asarray(self._tables.tangent, dtype=np.float64)
        self._normal = np.asarray(self._tables.normal, dtype=np.float64)

    @property
    def reference(self) -> np.ndarray:
        return self._reference

    @property
    def tables(self) -> frenet_ops.RefPathTables:
        """Device-resident tables for the batched kernels."""
        return self._tables

    @property
    def ref_pos(self) -> np.ndarray:
        return self._ref_pos

    @property
    def ref_curv(self) -> np.ndarray:
        return self._ref_curv

    @property
    def ref_curv_d(self) -> np.ndarray:
        return self._ref_curv_d

    @property
    def ref_curv_dd(self) -> np.ndarray:
        return self._ref_curv_dd

    @property
    def ref_theta(self) -> np.ndarray:
        return self._ref_theta

    def projection_domain(self, d_limit: Optional[float] = None) -> np.ndarray:
        """Closed polygon [N, 2] bounding the region of unique curvilinear
        projection (pycrccosy ``projection_domain()``, drawn by
        visualization.py:68-69 in the reference).

        The orthogonal projection onto the reference path is unique while the
        lateral offset stays below the curvature center on the bent side:
        |d| < 1/|kappa|.  The drawn outline matches the limits the rollout
        ENFORCES (ops/kinematics: normal-crossing 1 - kappa*d > 0 plus the
        pycrccosy 20 m default cap minus eps).
        """
        if d_limit is None:
            from commonroad_rp_jax.ops.kinematics import (
                _CLCS_EPS, PROJECTION_DOMAIN_LIMIT)
            d_limit = PROJECTION_DOMAIN_LIMIT - _CLCS_EPS
        kappa = np.abs(self._ref_curv)
        reach = np.where(kappa > 1e-12,
                         np.minimum(d_limit, 1.0 / np.maximum(kappa, 1e-12)),
                         d_limit)
        # curvature sign decides which side the center lies on; the opposite
        # side is unconstrained up to d_limit
        lo = np.where(self._ref_curv < 0.0, -reach, -d_limit)
        hi = np.where(self._ref_curv > 0.0, reach, d_limit)
        left = self._reference + hi[:, None] * self._normal
        right = self._reference + lo[:, None] * self._normal
        return np.concatenate([left, right[::-1], left[:1]], axis=0)

    def convert_to_cartesian_coords(self, s: float, d: float) -> Optional[np.ndarray]:
        """(s, d) -> (x, y); None outside the projection domain
        (utils_coordinate_system.py:167-174). Host/numpy."""
        if s < self._ref_pos[0] or s > self._ref_pos[-1]:
            return None
        seg = min(max(int(np.searchsorted(self._ref_pos, s, side="right")) - 1, 0),
                  len(self._ref_pos) - 2)
        ds = s - self._ref_pos[seg]
        # lateral projection-domain limits (same as ops/kinematics enforces:
        # normal crossing + the pycrccosy 20 m default cap minus eps)
        from commonroad_rp_jax.ops.kinematics import (_CLCS_EPS,
                                                      PROJECTION_DOMAIN_LIMIT)
        lam = ds / max(self._ref_pos[seg + 1] - self._ref_pos[seg], 1e-12)
        k_r = ((self._ref_curv[seg + 1] - self._ref_curv[seg]) * lam
               + self._ref_curv[seg])
        if 1.0 - k_r * d <= 0.0 or abs(d) >= PROJECTION_DOMAIN_LIMIT - _CLCS_EPS:
            return None
        return (self._reference[seg] + ds * self._tangent[seg] + d * self._normal[seg])

    def convert_to_curvilinear_coords(self, x: float, y: float) -> np.ndarray:
        """(x, y) -> (s, d) by orthogonal polyline projection
        (utils_coordinate_system.py:176-178). Native C++ when available,
        numpy fallback."""
        from commonroad_rp_jax import native
        if native.available():
            s_out, d_out, _ = native.clcs_project(
                self._reference, self._ref_pos, self._tangent, self._normal,
                np.array([[x, y]]))
            # same domain tolerance as the numpy fallback below: endpoints
            # (s = 0 or s = s_max) are inside
            if s_out[0] <= self._ref_pos[0] - 1e-9 or \
                    s_out[0] >= self._ref_pos[-1] + 1e-9:
                raise ValueError("Point outside the curvilinear projection domain")
            return np.array([s_out[0], d_out[0]])
        p = np.array([x, y])
        a = self._reference[:-1]
        t_hat = self._tangent[:-1]
        n_hat = self._normal[:-1]
        seg_len = np.diff(self._ref_pos)

        rel = p[None, :] - a
        t_proj = np.clip(np.sum(rel * t_hat, axis=1), 0.0, seg_len)
        closest = a + t_proj[:, None] * t_hat
        dist2 = np.sum((p[None, :] - closest) ** 2, axis=1)
        best = int(np.argmin(dist2))
        s = self._ref_pos[best] + t_proj[best]
        d = float(np.dot(rel[best], n_hat[best]))
        if s <= self._ref_pos[0] - 1e-9 or s >= self._ref_pos[-1] + 1e-9:
            raise ValueError("Point outside the curvilinear projection domain")
        return np.array([s, d])

    def compute_initial_curvilinear_states(self, position, orientation,
                                           velocity, acceleration,
                                           steering_angle, wheelbase,
                                           low_vel_mode: bool):
        """Cartesian state -> curvilinear (lon, lat) initial states.

        The Werling Eqs. A.3/A.5 transform of the reference's
        _compute_initial_states (reactive_planner.py:446-512), shared by the
        planner facade and the fleet problem setup.
        Returns ([s, s_dot, s_ddot], [d, d_dot, d_ddot]).
        """
        import math

        s, d = self.convert_to_curvilinear_coords(position[0], position[1])

        ref_pos = self._ref_pos
        s_idx = int(np.argmax(ref_pos > s)) - 1
        s_lambda = (s - ref_pos[s_idx]) / (ref_pos[s_idx + 1] - ref_pos[s_idx])

        ref_theta = np.unwrap(self._ref_theta)
        theta_cl = orientation - geometry.interpolate_angle(
            s, ref_pos[s_idx], ref_pos[s_idx + 1],
            ref_theta[s_idx], ref_theta[s_idx + 1])

        kr = (self._ref_curv[s_idx + 1] - self._ref_curv[s_idx]) * s_lambda \
            + self._ref_curv[s_idx]
        kr_d = (self._ref_curv_d[s_idx + 1] - self._ref_curv_d[s_idx]) \
            * s_lambda + self._ref_curv_d[s_idx]

        kappa_0 = np.tan(steering_angle) / wheelbase

        d_p = (1 - kr * d) * np.tan(theta_cl)
        d_pp = -(kr_d * d + kr * d_p) * np.tan(theta_cl) + \
            ((1 - kr * d) / (math.cos(theta_cl) ** 2)) * \
            (kappa_0 * (1 - kr * d) / math.cos(theta_cl) - kr)

        s_velocity = velocity * math.cos(theta_cl) / (1 - kr * d)
        if s_velocity < 0:
            raise Exception(
                "Initial state or reference incorrect! Curvilinear velocity is "
                "negative which indicates that the ego vehicle is not driving "
                "in the same direction as specified by the reference")

        s_acceleration = acceleration
        s_acceleration -= (s_velocity ** 2 / math.cos(theta_cl)) * (
            (1 - kr * d) * np.tan(theta_cl) *
            (kappa_0 * (1 - kr * d) / (math.cos(theta_cl)) - kr) -
            (kr_d * d + kr * d_p))
        s_acceleration /= ((1 - kr * d) / (math.cos(theta_cl)))

        if low_vel_mode:
            d_velocity = d_p
            d_acceleration = d_pp
        else:
            d_velocity = velocity * math.sin(theta_cl)
            d_acceleration = s_acceleration * d_p + s_velocity ** 2 * d_pp

        return [s, s_velocity, s_acceleration], [d, d_velocity, d_acceleration]

    def plot_reference_states(self):
        """Reference state plots (utils_coordinate_system.py:180-212)."""
        from matplotlib import pyplot as plt

        plt.figure(figsize=(7, 7.5))
        plt.suptitle("Reference path states")
        for i, (table, label) in enumerate([
                (self.ref_theta, "theta_ref"), (self.ref_curv, "kappa_ref"),
                (self.ref_curv_d, "kappa_dot_ref"),
                (self.ref_curv_dd, "kappa_dot_dot_ref")]):
            plt.subplot(4, 1, i + 1)
            plt.plot(self.ref_pos, table, color="k")
            plt.xlabel("s")
            plt.ylabel(label)
            if i >= 2:
                plt.ylim(-0.1, 0.1)
        plt.tight_layout()
        plt.show()
