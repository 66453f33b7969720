"""Curvilinear (Frenet) frame as dense device tables + batched transforms.

Device-array replacement for the C++ ``pycrccosy.CurvilinearCoordinateSystem``
(reference consumer: commonroad_rp/utility/utils_coordinate_system.py:86-178).
The reference crosses a pybind boundary once per point for Frenet->Cartesian
conversion (reactive_planner.py:910) — here the reference path is compiled
once into fixed-size arrays (positions, arclength, tangents, normals,
orientation, curvature tables) and conversion becomes a pure gather + FMA over
the whole [K, T] candidate batch.

Host-side construction lives in ``from_polyline`` (numpy); everything else is
jit-compatible jax.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.utils import geometry


class RefPathTables(NamedTuple):
    """Dense reference-path state tables (device-resident).

    Mirrors the precomputed tables of CoordinateSystem.__init__
    (utils_coordinate_system.py:114-118) plus per-segment tangent/normal
    frames for the Cartesian conversion.
    """

    points: jnp.ndarray      # [P, 2] vertices
    s: jnp.ndarray           # [P] arclength at each vertex (ref_pos)
    theta: jnp.ndarray       # [P] unwrapped orientation (ref_theta)
    curv: jnp.ndarray        # [P] curvature (ref_curv)
    curv_d: jnp.ndarray      # [P] curvature rate (ref_curv_d)
    curv_dd: jnp.ndarray     # [P] curvature rate change (ref_curv_dd)
    tangent: jnp.ndarray     # [P, 2] unit tangent of segment i (last repeats)
    normal: jnp.ndarray      # [P, 2] unit left normal of segment i


def from_polyline(polyline: np.ndarray, dtype=jnp.float64) -> RefPathTables:
    """Build the Frenet tables from an [P, 2] reference polyline (host, once).

    The polyline is expected to be the already-smoothed reference path (see
    utils/coordinate_system.py which applies the dedup + spline smoothing of
    utils_coordinate_system.py:93-104 first).
    """
    polyline = np.asarray(polyline, dtype=np.float64)
    s = geometry.compute_pathlength(polyline)
    theta = np.unwrap(geometry.compute_orientation(polyline))
    curv = geometry.compute_curvature(polyline)
    curv_d = np.gradient(curv, s)
    curv_dd = np.gradient(curv_d, s)

    seg = np.diff(polyline, axis=0)
    seg_len = np.linalg.norm(seg, axis=1, keepdims=True)
    tangent_seg = seg / seg_len
    tangent = np.concatenate((tangent_seg, tangent_seg[-1:]), axis=0)
    normal = np.stack((-tangent[:, 1], tangent[:, 0]), axis=1)

    as_dev = lambda a: jnp.asarray(a, dtype=dtype)
    return RefPathTables(points=as_dev(polyline), s=as_dev(s), theta=as_dev(theta),
                         curv=as_dev(curv), curv_d=as_dev(curv_d),
                         curv_dd=as_dev(curv_dd), tangent=as_dev(tangent),
                         normal=as_dev(normal))


# ---------------------------------------------------------------------------
# interpolation-index helpers (reference-quirk preserving)
# ---------------------------------------------------------------------------

def _searchsorted_right(table: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """searchsorted(side='right') into a sorted table, as int32."""
    return jnp.searchsorted(table, s, side="right").astype(jnp.int32)


def interp_index(ref: RefPathTables, s: jnp.ndarray) -> jnp.ndarray:
    """Index used by the reference for table interpolation.

    Replicates ``np.argmax(ref_pos > s) - 1`` (reactive_planner.py:464, :835):
    the index of the last vertex with s_vertex <= s — EXCEPT when s is beyond
    the final vertex, where argmax over an all-False mask yields 0 and hence
    index -1 (wrapping to the last vertex).  Returned indices may be -1; use
    ``gather_wrap`` to reproduce numpy's negative-index wrapping.
    """
    idx = _searchsorted_right(ref.s, s) - 1
    return jnp.where(s >= ref.s[-1], jnp.int32(-1), idx)


class InterpValues(NamedTuple):
    """Per-point reference-table values at idx and idx+1 (wrapped)."""

    s_lo: jnp.ndarray
    s_hi: jnp.ndarray
    theta_lo: jnp.ndarray
    theta_hi: jnp.ndarray
    curv_lo: jnp.ndarray
    curv_hi: jnp.ndarray
    curv_d_lo: jnp.ndarray
    curv_d_hi: jnp.ndarray


def lookup_interp_values(ref: RefPathTables, idx: jnp.ndarray) -> InterpValues:
    """All interpolation-table values for a batch of indices in two fused
    lookups (replaces eight separate gathers in the hot loop)."""
    P = ref.s.shape[0]
    idx_mod = idx % P
    packed = jnp.stack([ref.s, ref.theta, ref.curv, ref.curv_d], axis=1)
    packed_next = jnp.concatenate([packed[1:], packed[:1]], axis=0)
    lo = jnp.take(packed, idx_mod, axis=0)
    hi = jnp.take(packed_next, idx_mod, axis=0)
    return InterpValues(s_lo=lo[..., 0], s_hi=hi[..., 0],
                        theta_lo=lo[..., 1], theta_hi=hi[..., 1],
                        curv_lo=lo[..., 2], curv_hi=hi[..., 2],
                        curv_d_lo=lo[..., 3], curv_d_hi=hi[..., 3])


def gather_wrap(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] with numpy negative-index wrapping semantics."""
    return jnp.take(table, idx % table.shape[0], axis=0)


def interp_fraction(ref: RefPathTables, s: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation fraction s_lambda (reactive_planner.py:465-466)."""
    s_lo = gather_wrap(ref.s, idx)
    s_hi = gather_wrap(ref.s, idx + 1)
    return (s - s_lo) / (s_hi - s_lo)


def wrap_two_pi(angle: jnp.ndarray) -> jnp.ndarray:
    """Wrap into [-2*pi, 2*pi] (make_valid_orientation semantics,
    utils_coordinate_system.py:43)."""
    two_pi = 2.0 * jnp.pi
    return angle - two_pi * jnp.trunc(angle / two_pi)


def interpolate_angle_at(ref: RefPathTables, s: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Angle interpolation between vertices idx and idx+1 at arclength s.

    Batched equivalent of interpolate_angle (utils_coordinate_system.py:25-43)
    applied to the unwrapped ref_theta table, as done in the kinematic hot
    loop (reactive_planner.py:847-873).
    """
    x1 = gather_wrap(ref.s, idx)
    x2 = gather_wrap(ref.s, idx + 1)
    y1 = gather_wrap(ref.theta, idx)
    y2 = gather_wrap(ref.theta, idx + 1)
    return wrap_two_pi((y2 - y1) * (s - x1) / (x2 - x1) + y1)


def interp_table(ref_table: jnp.ndarray, idx: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """(table[idx+1] - table[idx]) * lambda + table[idx]
    (curvature interpolation form of reactive_planner.py:876-880)."""
    lo = gather_wrap(ref_table, idx)
    hi = gather_wrap(ref_table, idx + 1)
    return (hi - lo) * lam + lo


# ---------------------------------------------------------------------------
# Frenet -> Cartesian (batched; replaces per-point pycrccosy calls)
# ---------------------------------------------------------------------------

def to_cartesian(ref: RefPathTables, s: jnp.ndarray, d: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Convert (s, d) points to (x, y) with an out-of-domain mask.

    x = p_i + (s - s_i) * t_i + d * n_i over the segment containing s —
    the linear-segment model the C++ CLCS uses internally
    (convert_to_cartesian_coords, utils_coordinate_system.py:167-174).
    Points with s outside the table span are flagged out-of-domain, matching
    the C++ exception -> None -> infeasible path (reactive_planner.py:910-917).
    Shapes: s, d arbitrary (broadcast together); returns (x, y, in_domain).
    """
    P = ref.s.shape[0]
    seg = jnp.clip(_searchsorted_right(ref.s, s) - 1, 0, P - 2)
    geometry = jnp.concatenate([ref.points, ref.tangent, ref.normal,
                                ref.s[:, None]], axis=1)        # [P, 7]
    rows = jnp.take(geometry, seg, axis=0)
    ds = s - rows[..., 6]
    x = rows[..., 0] + ds * rows[..., 2] + d * rows[..., 4]
    y = rows[..., 1] + ds * rows[..., 3] + d * rows[..., 5]
    in_domain = (s >= ref.s[0]) & (s <= ref.s[-1])
    return x, y, in_domain


# ---------------------------------------------------------------------------
# Cartesian -> Frenet projection (needed once per cycle for x_0)
# ---------------------------------------------------------------------------

def to_curvilinear(ref: RefPathTables, x: jnp.ndarray, y: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Project Cartesian point(s) onto the reference path -> (s, d).

    Equivalent of pycrccosy convert_to_curvilinear_coords
    (utils_coordinate_system.py:176-178, used at reactive_planner.py:458):
    orthogonal projection onto the nearest polyline segment; d is the signed
    lateral offset (positive left of the path).
    """
    p = jnp.stack([x, y], axis=-1)[..., None, :]          # [..., 1, 2]
    a = ref.points[:-1]                                    # [P-1, 2]
    t_hat = ref.tangent[:-1]                               # [P-1, 2]
    n_hat = ref.normal[:-1]
    seg_len = ref.s[1:] - ref.s[:-1]

    rel = p - a                                            # [..., P-1, 2]
    t_proj = jnp.sum(rel * t_hat, axis=-1)                 # [..., P-1]
    t_clamped = jnp.clip(t_proj, 0.0, seg_len)
    closest = a + t_clamped[..., None] * t_hat
    dist2 = jnp.sum((p - closest) ** 2, axis=-1)
    best = jnp.argmin(dist2, axis=-1)

    take = lambda arr: jnp.take_along_axis(
        arr, best[..., None], axis=-1).squeeze(-1)
    t_best = take(t_clamped)
    s_out = jnp.take(ref.s[:-1], best) + t_best
    d_out = take(jnp.sum(rel * n_hat, axis=-1))
    return s_out, d_out
