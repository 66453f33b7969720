"""Batched collision checking: OBB obstacles + road-boundary segments.

Device-batched replacement for the C++ ``pycrcc`` collision pipeline
(reference: reactive_planner.py:218-256 scene construction,
:1019-1063 per-pose RectOBB + TimeVariantCollisionObject collide() calls).
The scene is compiled once on the host into dense arrays — obstacle pose
tables [M, T, 5] with validity masks and road-boundary segments [B, 4] —
and the per-cycle check is a single vectorized separating-axis program over
[K candidates x T steps x M obstacles] plus [K x T x B] segment tests.

The reference checks collisions lazily in cost-sorted order and stops at the
first non-colliding candidate (:1031-1062); the dense equivalent computes the
full mask and the planner derives both the selected candidate and the
"colliding candidates visited before the winner" statistic from it
(SURVEY.md section 7: selection semantics, not control flow).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.utils.scenario import (Circle, Polygon, Rectangle,
                                              Scenario)


class ObstacleArrays(NamedTuple):
    """Dense obstacle occupancy tables, device-resident.

    Box/disc group (every obstacle whose occupancy is an OBB or a disc):
      pose: [M, T, 3]  (center x, center y, orientation)
      half_ext: [M, 2] (half length, half width; (0, 0) for discs)
      valid: [M, T]    occupancy exists at that scenario time step
      radius: [M]      disc radius; 0 marks an OBB row.  None when the scene
                       has no circle obstacles (pure-OBB fast layout).

    Polygon group (convex pieces of polygon obstacles; exact SAT on device —
    pycrcc collides exact polygon primitives, reactive_planner.py:236-239):
      poly_verts: [Mp, T, V, 2]  world-frame vertices per step, padded along
                                 V by repeating the last vertex (degenerate
                                 edges contribute no separating axis)
      poly_valid: [Mp, T]
    Both None when the scene has no polygon obstacles.
    """

    pose: jnp.ndarray
    half_ext: jnp.ndarray
    valid: jnp.ndarray
    radius: Optional[jnp.ndarray] = None
    poly_verts: Optional[jnp.ndarray] = None
    poly_valid: Optional[jnp.ndarray] = None


class BoundaryArrays(NamedTuple):
    """Road-boundary segments [B, 2, 2] ((x1,y1),(x2,y2)) + validity [B]."""

    segments: jnp.ndarray
    valid: jnp.ndarray


class CorridorArrays(NamedTuple):
    """Drivable band in the reference-path frame: for each path vertex the
    signed lateral offsets of the nearest road boundary on either side.

    Fast equivalent of the boundary-obstacle collision check: instead of
    testing the ego OBB against every boundary segment ([K, T, B] SAT), the
    rollout's native (s, d) states are compared against gathered d-band
    limits — O(K*T) gathers (SURVEY.md section 7 hard part 5: the boundary
    needs a compact representation rather than the reference's triangle soup).
    """

    d_lo: jnp.ndarray                      # [P] right-side boundary offset (<0)
    d_hi: jnp.ndarray                      # [P] left-side boundary offset (>0)


# Corridor-band value contract: every band is a multiple of 2**-10 m (1 mm)
# clamped to [-32, 32] m.  Semantics-free given the 19.9 m lateral
# projection-domain cap (|d_center| + lat_ext < 24 m for any in-domain
# candidate, so a band at +-32 never binds), and the quantization shrinks the
# drivable band by at most 1 mm on each side (conservative: floor on d_hi,
# ceil on d_lo).  Every band is then exactly representable in float32, so the
# float32 and float64 programs compare the same band values.
BAND_CLAMP = 32.0
_BAND_QUANTUM = 1024.0   # 2**10 per metre


def quantize_bands(d_lo, d_hi):
    """(d_lo, d_hi) quantized to the corridor-band value contract (see
    module comment above): 1 mm grid, [-32, 32] m clamp, conservative
    rounding (the band only ever shrinks)."""
    d_hi_q = np.floor(np.clip(np.asarray(d_hi, np.float64), -BAND_CLAMP,
                              BAND_CLAMP) * _BAND_QUANTUM) / _BAND_QUANTUM
    d_lo_q = np.ceil(np.clip(np.asarray(d_lo, np.float64), -BAND_CLAMP,
                             BAND_CLAMP) * _BAND_QUANTUM) / _BAND_QUANTUM
    return d_lo_q, d_hi_q


# ---------------------------------------------------------------------------
# host-side scene compilation
# ---------------------------------------------------------------------------

def compile_obstacles(scenario: Scenario, t_start: int, horizon_steps: int,
                      factor: int = 1, dtype=jnp.float64) -> ObstacleArrays:
    """Flatten scenario obstacles into [M, T] occupancy tables for one window.

    Plays the role of create_collision_object per obstacle
    (reactive_planner.py:235-245) with pycrcc's exact shape primitives:
    rectangles become OBB rows, circles disc rows (half_ext (0,0) + radius),
    polygons convex pieces in the polygon group (concave inputs are
    ear-clipped on the host, ``utils.geometry.decompose_polygon``).  Static
    obstacles occupy every step; dynamic obstacles occupy the steps covered
    by their trajectory prediction (no occupancy -> no collision, matching
    pycrcc time-variant semantics).  Queried ego step i corresponds to
    scenario step t_start + i * factor (:1040).
    """
    from commonroad_rp_jax.utils.geometry import decompose_polygon

    T = horizon_steps + 1
    rows_pose: List[np.ndarray] = []
    rows_ext: List[Tuple[float, float]] = []
    rows_valid: List[np.ndarray] = []
    rows_radius: List[float] = []
    poly_piece_verts: List[np.ndarray] = []      # body-frame [V, 2] per piece
    poly_piece_states: List[List] = []           # per-step (pos, theta) or None

    def world_center(state, offset: np.ndarray):
        center = np.asarray(state.position, dtype=np.float64)
        theta = float(state.orientation or 0.0)
        if offset[0] or offset[1]:
            c, s = np.cos(theta), np.sin(theta)
            center = center + np.array([c * offset[0] - s * offset[1],
                                        s * offset[0] + c * offset[1]])
        return center, theta

    def states_over_window(obstacle, static: bool):
        """Per-ego-step obstacle state (None = no occupancy)."""
        if static:
            return [obstacle.initial_state] * T
        return [obstacle.state_at_time(t_start + i * factor) for i in range(T)]

    def add_obstacle(obstacle, static: bool):
        shape = obstacle.shape
        states = states_over_window(obstacle, static)
        if isinstance(shape, (Rectangle, Circle)):
            if isinstance(shape, Rectangle):
                offset = np.asarray(shape.center, dtype=np.float64)
                d_theta = float(shape.orientation)
                ext = (0.5 * shape.length, 0.5 * shape.width)
                radius = 0.0
            else:
                offset = np.asarray(shape.center, dtype=np.float64)
                d_theta = 0.0
                ext = (0.0, 0.0)
                radius = float(shape.radius)
            pose = np.zeros((T, 3))
            valid = np.zeros(T, dtype=bool)
            for i, state in enumerate(states):
                if state is not None and state.position is not None:
                    center, theta = world_center(state, offset)
                    pose[i] = [center[0], center[1], theta + d_theta]
                    valid[i] = True
            rows_pose.append(pose)
            rows_ext.append(ext)
            rows_valid.append(valid)
            rows_radius.append(radius)
        elif isinstance(shape, Polygon):
            pieces = decompose_polygon(shape.points)
            step_states = [(np.asarray(s.position, dtype=np.float64),
                            float(s.orientation or 0.0))
                           if s is not None and s.position is not None else None
                           for s in states]
            for piece in pieces:
                poly_piece_verts.append(piece)
                poly_piece_states.append(step_states)
        else:
            raise ValueError(f"unsupported obstacle shape {type(shape)}")

    for obstacle in scenario.static_obstacles:
        add_obstacle(obstacle, static=True)
    for obstacle in scenario.dynamic_obstacles:
        add_obstacle(obstacle, static=False)

    if rows_pose:
        pose = jnp.asarray(np.stack(rows_pose), dtype=dtype)
        half_ext = jnp.asarray(np.array(rows_ext), dtype=dtype)
        valid = jnp.asarray(np.stack(rows_valid))
        radius_arr = np.asarray(rows_radius)
        radius = jnp.asarray(radius_arr, dtype=dtype) \
            if np.any(radius_arr > 0) else None
    else:
        pose = jnp.zeros((0, T, 3), dtype=dtype)
        half_ext = jnp.zeros((0, 2), dtype=dtype)
        valid = jnp.zeros((0, T), dtype=bool)
        radius = None

    poly_verts = poly_valid = None
    if poly_piece_verts:
        V_max = max(len(p) for p in poly_piece_verts)
        Mp = len(poly_piece_verts)
        verts = np.zeros((Mp, T, V_max, 2))
        pvalid = np.zeros((Mp, T), dtype=bool)
        for m, (body, step_states) in enumerate(
                zip(poly_piece_verts, poly_piece_states)):
            padded = np.concatenate(
                [body, np.repeat(body[-1:], V_max - len(body), axis=0)])
            for i, st in enumerate(step_states):
                if st is None:
                    continue
                position, theta = st
                c, s = np.cos(theta), np.sin(theta)
                rot = np.array([[c, -s], [s, c]])
                verts[m, i] = padded @ rot.T + position
                pvalid[m, i] = True
        poly_verts = jnp.asarray(verts, dtype=dtype)
        poly_valid = jnp.asarray(pvalid)

    return ObstacleArrays(pose=pose, half_ext=half_ext, valid=valid,
                          radius=radius, poly_verts=poly_verts,
                          poly_valid=poly_valid)


def compile_road_boundary(scenario: Scenario, dtype=jnp.float64) -> BoundaryArrays:
    """Extract the outer boundary of the drivable area as segment arrays.

    Equivalent of create_road_boundary_obstacle (reactive_planner.py:246-248),
    which triangulates the lanelet-network complement in C++.  Here the
    boundary is derived from lanelet topology and geometry: a lanelet's
    left/right bound is a road boundary wherever no adjacent lanelet shares it
    AND the segment is not interior to the union of lanelet polygons (lanelets
    overlap without adjacency links inside junction areas).
    """
    from commonroad_rp_jax.utils.scenario import point_in_polygon

    lanelets = scenario.lanelet_network.lanelets
    polygons = {l.lanelet_id: l.polygon for l in lanelets}

    def interior(seg_a: np.ndarray, seg_b: np.ndarray, own_id: int) -> bool:
        """Segment lies inside the UNION of other lanelet polygons (junction
        overlap).  Each probe may be covered by a different lanelet — at a
        T-junction a lanelet edge can cross several turning lanelets, none of
        which contains the whole segment alone."""
        others = [poly for lanelet_id, poly in polygons.items()
                  if lanelet_id != own_id]
        probes = [f * seg_a + (1.0 - f) * seg_b
                  for f in (0.1, 0.3, 0.5, 0.7, 0.9)]
        return all(any(point_in_polygon(p, poly) for poly in others)
                   for p in probes)

    segments: List[np.ndarray] = []
    for lanelet in lanelets:
        for side, adjacent in (("left", lanelet.adj_left),
                               ("right", lanelet.adj_right)):
            if adjacent is not None:
                continue
            pts = lanelet.left_vertices if side == "left" else lanelet.right_vertices
            for a, b in zip(pts[:-1], pts[1:]):
                if not interior(a, b, lanelet.lanelet_id):
                    segments.append(np.stack([a, b]))
    if not segments:
        return BoundaryArrays(segments=jnp.zeros((0, 2, 2), dtype=dtype),
                              valid=jnp.zeros((0,), dtype=bool))
    seg = np.stack(segments)
    return BoundaryArrays(segments=jnp.asarray(seg, dtype=dtype),
                          valid=jnp.ones(len(seg), dtype=bool))


def compile_corridor(boundary: BoundaryArrays, ref_tables,
                     d_default: float = 1e4, dtype=jnp.float64) -> CorridorArrays:
    """Build the drivable d-band along the reference path (host, once).

    For each reference vertex, intersect the lateral normal line with every
    road-boundary segment; the nearest intersection on each side bounds the
    drivable band.  Where no boundary crosses the normal, a large default
    keeps the side unbounded.
    """
    points = np.asarray(ref_tables.points, dtype=np.float64)       # [P, 2]
    normals = np.asarray(ref_tables.normal, dtype=np.float64)      # [P, 2]
    segments = np.asarray(boundary.segments, dtype=np.float64)     # [B, 2, 2]
    P = len(points)
    if segments.shape[0] == 0:
        big = np.full(P, d_default)
        d_lo, d_hi = quantize_bands(-big, big)
        return CorridorArrays(d_lo=jnp.asarray(d_lo, dtype),
                              d_hi=jnp.asarray(d_hi, dtype))

    from commonroad_rp_jax import native
    if native.available():
        d_lo, d_hi = native.corridor_sweep(points, normals, segments,
                                           d_default=d_default)
        d_lo, d_hi = quantize_bands(d_lo, d_hi)
        return CorridorArrays(d_lo=jnp.asarray(d_lo, dtype),
                              d_hi=jnp.asarray(d_hi, dtype))

    a = segments[:, 0]                                             # [B, 2]
    b = segments[:, 1]
    ab = b - a                                                     # [B, 2]

    # solve p + t*n = a + u*ab for each (vertex, segment) pair
    # [P, B] linear systems via cross products
    n = normals[:, None, :]                                        # [P, 1, 2]
    ap = a[None, :, :] - points[:, None, :]                        # [P, B, 2]
    denom = n[..., 0] * (-ab[None, :, 1]) - n[..., 1] * (-ab[None, :, 0])
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (ap[..., 0] * (-ab[None, :, 1]) - ap[..., 1] * (-ab[None, :, 0])) / denom
    u = (n[..., 0] * ap[..., 1] - n[..., 1] * ap[..., 0]) / denom
    hit = (u >= -1e-9) & (u <= 1 + 1e-9) & np.isfinite(t)

    t_pos = np.where(hit & (t > 1e-9), t, np.inf)
    t_neg = np.where(hit & (t < -1e-9), t, -np.inf)
    d_hi = np.minimum(t_pos.min(axis=1), d_default)
    d_lo = np.maximum(t_neg.max(axis=1), -d_default)
    d_lo, d_hi = quantize_bands(d_lo, d_hi)
    return CorridorArrays(d_lo=jnp.asarray(d_lo, dtype),
                          d_hi=jnp.asarray(d_hi, dtype))


def check_corridor(s: jnp.ndarray, d: jnp.ndarray, theta_cl: jnp.ndarray,
                   ref_s: jnp.ndarray, corridor: CorridorArrays,
                   half_length: jnp.ndarray, half_width: jnp.ndarray,
                   wb_rear_axle: jnp.ndarray,
                   active: Optional[jnp.ndarray] = None,
                   s_last: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Road-boundary violation mask [K] from curvilinear rollout states.

    The ego OBB (centered wb_rear_axle ahead of the rear axle along the
    heading) is conservatively boxed in the road frame: lateral half-extent
    |half_width cos(theta_cl)| + |half_length sin(theta_cl)|, probed at the
    front/center/rear longitudinal stations.  Probes clamp into the path
    span [ref_s[0], s_last] (``s_last`` defaults to ``ref_s[-1]``; pass the
    true path end when ``ref_s`` carries sentinel padding rows), which is
    the clipped-segment convention at the path ends.
    """
    P = ref_s.shape[0]
    # T-major internally (candidates on the vector lanes)
    s_t, d_t, theta_t = s.T, d.T, theta_cl.T
    s_center = s_t + wb_rear_axle * jnp.cos(theta_t)
    d_center = d_t + wb_rear_axle * jnp.sin(theta_t)
    lat_ext = (half_width * jnp.abs(jnp.cos(theta_t)) +
               half_length * jnp.abs(jnp.sin(theta_t)))
    lon_ext = (half_length * jnp.abs(jnp.cos(theta_t)) +
               half_width * jnp.abs(jnp.sin(theta_t)))

    bands = jnp.stack([corridor.d_lo, corridor.d_hi], axis=1)        # [P, 2]
    s_hi = ref_s[-1] if s_last is None else s_last

    violate = jnp.zeros(s_t.shape, dtype=bool)
    for offset in (-1.0, 0.0, 1.0):
        s_probe = jnp.clip(s_center + offset * lon_ext, ref_s[0], s_hi)
        seg = jnp.clip(jnp.searchsorted(ref_s, s_probe, side="right") - 1,
                       0, P - 1)
        rows = jnp.take(bands, seg, axis=0)
        lo, hi = rows[..., 0], rows[..., 1]
        violate = violate | (d_center + lat_ext > hi) | (d_center - lat_ext < lo)
    if active is not None:
        violate = violate & active.T
    return jnp.any(violate, axis=0)


def pad_obstacles(obstacles: ObstacleArrays, m_max: int) -> ObstacleArrays:
    """Pad the box/disc obstacle axis to a fixed size (invalid rows) for
    static shapes.  The polygon group passes through unchanged."""
    M, T, _ = obstacles.pose.shape
    if M == m_max:
        return obstacles
    assert M < m_max, f"more obstacles ({M}) than padding target ({m_max})"
    pad = m_max - M
    radius = obstacles.radius
    if radius is not None:
        radius = jnp.concatenate([radius, jnp.zeros((pad,), radius.dtype)])
    return ObstacleArrays(
        pose=jnp.concatenate([obstacles.pose,
                              jnp.zeros((pad, T, 3), obstacles.pose.dtype)]),
        half_ext=jnp.concatenate([obstacles.half_ext,
                                  jnp.ones((pad, 2), obstacles.half_ext.dtype)]),
        valid=jnp.concatenate([obstacles.valid, jnp.zeros((pad, T), dtype=bool)]),
        radius=radius, poly_verts=obstacles.poly_verts,
        poly_valid=obstacles.poly_valid)


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def _obb_axes(theta: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unit axes (major, minor) of an OBB with orientation theta [..., 2]."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    major = jnp.stack([c, s], axis=-1)
    minor = jnp.stack([-s, c], axis=-1)
    return major, minor


def _project_radius(axis: jnp.ndarray, major: jnp.ndarray, minor: jnp.ndarray,
                    half_ext: jnp.ndarray) -> jnp.ndarray:
    """Projection radius of an OBB onto a unit axis."""
    return (half_ext[..., 0] * jnp.abs(jnp.sum(axis * major, axis=-1)) +
            half_ext[..., 1] * jnp.abs(jnp.sum(axis * minor, axis=-1)))


def obb_overlap(center_a, theta_a, half_a, center_b, theta_b, half_b) -> jnp.ndarray:
    """Separating-axis OBB-OBB overlap test; broadcasts over leading dims.

    Batched equivalent of pycrcc.RectOBB vs RectOBB collide()
    (reactive_planner.py:1041-1042).
    """
    maj_a, min_a = _obb_axes(theta_a)
    maj_b, min_b = _obb_axes(theta_b)
    delta = center_b - center_a

    overlap = jnp.ones(delta.shape[:-1], dtype=bool)
    for axis in (maj_a, min_a, maj_b, min_b):
        dist = jnp.abs(jnp.sum(delta * axis, axis=-1))
        r_a = _project_radius(axis, maj_a, min_a, half_a)
        r_b = _project_radius(axis, maj_b, min_b, half_b)
        overlap = overlap & (dist <= r_a + r_b)
    return overlap


def disc_obb_overlap(disc_center, radius, box_center, box_theta,
                     box_half) -> jnp.ndarray:
    """Exact disc vs OBB overlap (closest-point test); broadcasts leading dims.

    Batched equivalent of pycrcc.Circle vs RectOBB collide()
    (reactive_planner.py:236-239 via create_collision_object): the disc
    center is clamped into the box frame; overlap iff the clamped point lies
    within the radius.  Exact — no corner over-approximation.
    """
    major, minor = _obb_axes(box_theta)
    delta = disc_center - box_center
    lx = jnp.abs(jnp.sum(delta * major, axis=-1))
    ly = jnp.abs(jnp.sum(delta * minor, axis=-1))
    qx = jnp.maximum(lx - box_half[..., 0], 0.0)
    qy = jnp.maximum(ly - box_half[..., 1], 0.0)
    return qx * qx + qy * qy <= radius * radius


def _poly_obb_overlap_tmajor(vt, pvalid_t, cx, cy, e_cos, e_sin,
                             ehl, ehw) -> jnp.ndarray:
    """Exact convex-polygon vs ego-OBB SAT in the T-major layout.

    vt: [T, Mp, V, 2] world vertices (padded V repeats the final vertex);
    pvalid_t: [T, Mp]; cx/cy/e_cos/e_sin: [T, K] ego OBB center poses;
    ehl/ehw: scalar half extents.  Returns the hit mask [T, Mp, K].

    Axes: the 2 ego box axes + the polygon's V edge normals
    (exact for convex-convex SAT).  Edge normals stay unnormalized — the
    ego projection radius and the polygon interval scale identically, and
    zero-length padded edges then contribute no separating axis.
    """
    # ego axes: project polygon vertices into the ego frame
    rel_x = vt[..., 0][:, :, :, None] - cx[:, None, None, :]   # [T, Mp, V, K]
    rel_y = vt[..., 1][:, :, :, None] - cy[:, None, None, :]
    ec = e_cos[:, None, None, :]
    es = e_sin[:, None, None, :]
    proj_major = rel_x * ec + rel_y * es
    proj_minor = -rel_x * es + rel_y * ec
    sep = (jnp.min(proj_major, axis=2) > ehl) | \
          (jnp.max(proj_major, axis=2) < -ehl)
    sep = sep | (jnp.min(proj_minor, axis=2) > ehw) | \
        (jnp.max(proj_minor, axis=2) < -ehw)                   # [T, Mp, K]

    # polygon edge-normal axes (candidate-independent intervals)
    edges = jnp.roll(vt, -1, axis=2) - vt                      # [T, Mp, V, 2]
    nx = -edges[..., 1]
    ny = edges[..., 0]
    # polygon's own projection interval on each normal: [T, Mp, V]
    vert_proj = (nx[..., None] * vt[..., 0][:, :, None, :] +
                 ny[..., None] * vt[..., 1][:, :, None, :])    # [T, Mp, Vax, Vv]
    lo_n = jnp.min(vert_proj, axis=-1)
    hi_n = jnp.max(vert_proj, axis=-1)
    # ego center projection + projection radius on each normal
    c_proj = (nx[..., None] * cx[:, None, None, :] +
              ny[..., None] * cy[:, None, None, :])            # [T, Mp, V, K]
    r_ego = (ehl * jnp.abs(nx[..., None] * ec + ny[..., None] * es) +
             ehw * jnp.abs(-nx[..., None] * es + ny[..., None] * ec))
    sep_n = (c_proj - r_ego > hi_n[..., None]) | \
            (c_proj + r_ego < lo_n[..., None])
    sep = sep | jnp.any(sep_n, axis=2)
    return ~sep & pvalid_t[:, :, None]


def obb_segment_overlap(center, theta, half_ext, seg_a, seg_b) -> jnp.ndarray:
    """Separating-axis OBB vs line-segment overlap; broadcasts leading dims.

    Axes: the two box axes plus the segment normal (exact for convex vs
    segment).  Used for the road-boundary check replacing the triangle-soup
    boundary obstacle (reactive_planner.py:246-248).
    """
    major, minor = _obb_axes(theta)
    mid = 0.5 * (seg_a + seg_b)
    half_seg = 0.5 * (seg_b - seg_a)
    delta = mid - center

    overlap = jnp.ones(delta.shape[:-1], dtype=bool)
    for axis in (major, minor):
        dist = jnp.abs(jnp.sum(delta * axis, axis=-1))
        r_box = _project_radius(axis, major, minor, half_ext)
        r_seg = jnp.abs(jnp.sum(half_seg * axis, axis=-1))
        overlap = overlap & (dist <= r_box + r_seg)
    seg_dir = seg_b - seg_a
    normal = jnp.stack([-seg_dir[..., 1], seg_dir[..., 0]], axis=-1)
    norm_len = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.where(norm_len > 0, norm_len, 1.0)
    dist = jnp.abs(jnp.sum(delta * normal, axis=-1))
    r_box = _project_radius(normal, major, minor, half_ext)
    overlap = overlap & (dist <= r_box)
    return overlap


def merge_obb_pairs(center: jnp.ndarray, theta: jnp.ndarray,
                    half_ext: jnp.ndarray):
    """Enclose consecutive OBB pairs along the time axis in one OBB each.

    Batched closed-form equivalent of the C++ ``trajectory_preprocess_obb_sum``
    (reference: reactive_planner.py:241, :1053): for poses at steps t and t+1
    build an OBB with the circular-mean orientation whose half-extents cover
    both boxes (projected corner radii plus center-offset projections).

    Shapes: center [..., T, 2], theta [..., T], half_ext broadcastable
    [..., 2]; returns (center_m [..., T-1, 2], theta_m [..., T-1],
    half_m [..., T-1, 2]).
    """
    c0, c1 = center[..., :-1, :], center[..., 1:, :]
    t0, t1 = theta[..., :-1], theta[..., 1:]
    theta_m = jnp.arctan2(jnp.sin(t0) + jnp.sin(t1), jnp.cos(t0) + jnp.cos(t1))
    center_m = 0.5 * (c0 + c1)
    major, minor = _obb_axes(theta_m)

    hl = jnp.broadcast_to(half_ext[..., None, 0], t0.shape)
    hw = jnp.broadcast_to(half_ext[..., None, 1], t0.shape)

    def cover(c_i, t_i):
        # projection radius of box i onto the merged axes + center offset
        d_theta = t_i - theta_m
        r_major = hl * jnp.abs(jnp.cos(d_theta)) + hw * jnp.abs(jnp.sin(d_theta))
        r_minor = hl * jnp.abs(jnp.sin(d_theta)) + hw * jnp.abs(jnp.cos(d_theta))
        off = c_i - center_m
        off_major = jnp.abs(jnp.sum(off * major, axis=-1))
        off_minor = jnp.abs(jnp.sum(off * minor, axis=-1))
        return off_major + r_major, off_minor + r_minor

    a_major, a_minor = cover(c0, t0)
    b_major, b_minor = cover(c1, t1)
    half_m = jnp.stack([jnp.maximum(a_major, b_major),
                        jnp.maximum(a_minor, b_minor)], axis=-1)
    return center_m, theta_m, half_m


def check_collisions_continuous(x: jnp.ndarray, y: jnp.ndarray,
                                theta: jnp.ndarray,
                                obstacles: ObstacleArrays,
                                half_length: jnp.ndarray,
                                half_width: jnp.ndarray,
                                wb_rear_axle: jnp.ndarray) -> jnp.ndarray:
    """Swept (continuous) collision mask [K]: merged consecutive ego OBBs vs
    merged consecutive obstacle OBBs (reference continuous mode,
    reactive_planner.py:1049-1058 with obstacle preprocessing at :240-244).

    Like pycrcc's ``trajectory_preprocess_obb_sum``, non-rectangle occupancy
    pairs are enclosed in covering OBBs: discs as their bounding squares
    (half extents = radius) before merging, polygon pieces as the
    axis-aligned box covering both steps' vertices — the same class of
    over-approximation the reference's preprocessing applies.
    """
    cx = x + wb_rear_axle * jnp.cos(theta)
    cy = y + wb_rear_axle * jnp.sin(theta)
    ego_center = jnp.stack([cx, cy], axis=-1)                         # [K, T, 2]
    ego_half = jnp.stack([jnp.broadcast_to(half_length, theta.shape[:1]),
                          jnp.broadcast_to(half_width, theta.shape[:1])],
                         axis=-1)                                     # [K, 2]
    ego_c, ego_t, ego_h = merge_obb_pairs(ego_center, theta, ego_half)

    collides = jnp.zeros(x.shape[0], dtype=bool)

    if obstacles.pose.shape[0] > 0:
        half_ext = obstacles.half_ext
        if obstacles.radius is not None:
            r = obstacles.radius
            half_ext = jnp.where((r > 0)[:, None],
                                 jnp.stack([r, r], axis=-1), half_ext)
        obs_c, obs_t, obs_h = merge_obb_pairs(
            obstacles.pose[..., :2], obstacles.pose[..., 2], half_ext)
        pair_valid = obstacles.valid[:, :-1] & obstacles.valid[:, 1:]  # [M, T-1]

        # [K, T-1, M]
        hit = obb_overlap(ego_c[:, :, None, :], ego_t[:, :, None],
                          ego_h[:, :, None, :],
                          obs_c.transpose(1, 0, 2)[None, :, :, :],
                          obs_t.T[None, :, :],
                          obs_h.transpose(1, 0, 2)[None, :, :, :])
        hit = hit & pair_valid.T[None, :, :]
        collides = collides | jnp.any(hit, axis=(1, 2))

    if obstacles.poly_verts is not None:
        vt = obstacles.poly_verts                                 # [Mp, T, V, 2]
        pair_min = jnp.minimum(vt[:, :-1], vt[:, 1:]).min(axis=2)  # [Mp, T-1, 2]
        pair_max = jnp.maximum(vt[:, :-1], vt[:, 1:]).max(axis=2)
        p_center = 0.5 * (pair_min + pair_max)
        p_half = 0.5 * (pair_max - pair_min)
        p_theta = jnp.zeros(p_half.shape[:-1], p_half.dtype)
        pair_valid = obstacles.poly_valid[:, :-1] & obstacles.poly_valid[:, 1:]
        hit = obb_overlap(ego_c[:, :, None, :], ego_t[:, :, None],
                          ego_h[:, :, None, :],
                          p_center.transpose(1, 0, 2)[None, :, :, :],
                          p_theta.T[None, :, :],
                          p_half.transpose(1, 0, 2)[None, :, :, :])
        hit = hit & pair_valid.T[None, :, :]
        collides = collides | jnp.any(hit, axis=(1, 2))

    return collides


def check_collisions(x: jnp.ndarray, y: jnp.ndarray, theta: jnp.ndarray,
                     obstacles: ObstacleArrays,
                     boundary: Optional[BoundaryArrays],
                     half_length: jnp.ndarray, half_width: jnp.ndarray,
                     wb_rear_axle: jnp.ndarray) -> jnp.ndarray:
    """Collision mask [K] for ego trajectories [K, T] (rear-axle positions).

    Mirrors _check_collisions pose construction (reactive_planner.py:1033-1041):
    the ego OBB is centered at the rear-axle position shifted forward by
    wb_rear_axle along the heading.
    """
    # T-major / K-minor internally: broadcast layout [T, M|B, K] keeps the
    # candidate axis on the vector lanes (M and B are small)
    theta_t = theta.T                                        # [T, K]
    cx = x.T + wb_rear_axle * jnp.cos(theta_t)
    cy = y.T + wb_rear_axle * jnp.sin(theta_t)
    e_cos = jnp.cos(theta_t)[:, None, :]                     # [T, 1, K]
    e_sin = jnp.sin(theta_t)[:, None, :]
    ex = cx[:, None, :]
    ey = cy[:, None, :]
    ehl, ehw = half_length, half_width

    collides = jnp.zeros(x.shape[0], dtype=bool)

    if obstacles.pose.shape[0] > 0:
        ox = obstacles.pose[..., 0].T[:, :, None]            # [T, M, 1]
        oy = obstacles.pose[..., 1].T[:, :, None]
        otheta = obstacles.pose[..., 2].T[:, :, None]
        ohl = obstacles.half_ext[:, 0][None, :, None]
        ohw = obstacles.half_ext[:, 1][None, :, None]

        o_cos = jnp.cos(otheta)
        o_sin = jnp.sin(otheta)
        dx = ox - ex                                         # [T, M, K]
        dy = oy - ey
        rel_cos = jnp.abs(e_cos * o_cos + e_sin * o_sin)
        rel_sin = jnp.abs(o_sin * e_cos - o_cos * e_sin)

        lx = jnp.abs(dx * e_cos + dy * e_sin)
        ly = jnp.abs(-dx * e_sin + dy * e_cos)
        sep = lx > ehl + ohl * rel_cos + ohw * rel_sin
        sep = sep | (ly > ehw + ohl * rel_sin + ohw * rel_cos)
        sep = sep | (jnp.abs(dx * o_cos + dy * o_sin) >
                     ohl + ehl * rel_cos + ehw * rel_sin)
        sep = sep | (jnp.abs(-dx * o_sin + dy * o_cos) >
                     ohw + ehl * rel_sin + ehw * rel_cos)
        hit = ~sep
        if obstacles.radius is not None:
            # exact disc rows (closest-point test in the ego frame) — pycrcc
            # collides exact circles, not their bounding squares
            r = obstacles.radius[None, :, None]                  # [1, M, 1]
            qx = jnp.maximum(lx - ehl, 0.0)
            qy = jnp.maximum(ly - ehw, 0.0)
            disc_hit = qx * qx + qy * qy <= r * r
            hit = jnp.where(r > 0, disc_hit, hit)
        hit = hit & obstacles.valid.T[:, :, None]
        collides = collides | jnp.any(hit, axis=(0, 1))

    if obstacles.poly_verts is not None:
        vt = obstacles.poly_verts.transpose(1, 0, 2, 3)          # [T, Mp, V, 2]
        hit_p = _poly_obb_overlap_tmajor(
            vt, obstacles.poly_valid.T, cx, cy,
            jnp.cos(theta_t), jnp.sin(theta_t), ehl, ehw)
        collides = collides | jnp.any(hit_p, axis=(0, 1))

    if boundary is not None and boundary.segments.shape[0] > 0:
        ego_center = jnp.stack([cx, cy], axis=-1)            # [T, K, 2]
        ego_half = jnp.stack([jnp.broadcast_to(ehl, cx.shape),
                              jnp.broadcast_to(ehw, cx.shape)], axis=-1)
        seg_a = boundary.segments[None, :, None, 0, :]       # [1, B, 1, 2]
        seg_b = boundary.segments[None, :, None, 1, :]
        hit_b = obb_segment_overlap(ego_center[:, None, :, :],
                                    theta_t[:, None, :],
                                    ego_half[:, None, :, :], seg_a, seg_b)
        hit_b = hit_b & boundary.valid[None, :, None]        # [T, B, K]
        collides = collides | jnp.any(hit_b, axis=(0, 1))

    return collides
