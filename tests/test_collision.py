"""Collision kernels: OBB SAT, segments, corridor bands, swept OBBs."""

import numpy as np
import pytest

import jax.numpy as jnp

from commonroad_rp_jax.ops import collision as co


def test_obb_overlap_basic():
    # identical boxes overlap
    c = jnp.asarray([0.0, 0.0])
    assert bool(co.obb_overlap(c, 0.0, jnp.asarray([1.0, 0.5]),
                               c, 0.0, jnp.asarray([1.0, 0.5])))
    # separated along x
    assert not bool(co.obb_overlap(c, 0.0, jnp.asarray([1.0, 0.5]),
                                   jnp.asarray([2.5, 0.0]), 0.0,
                                   jnp.asarray([1.0, 0.5])))
    # rotated box: diagonal reach (1*cos45 + 0.5*sin45 ~ 1.06) closes the gap
    assert bool(co.obb_overlap(c, 0.0, jnp.asarray([1.0, 0.5]),
                               jnp.asarray([2.0, 0.0]), jnp.pi / 4,
                               jnp.asarray([1.0, 0.5])))
    # at 2.2 the reach (1.06) leaves a gap on the x axis: separated
    assert not bool(co.obb_overlap(c, 0.0, jnp.asarray([1.0, 0.5]),
                                   jnp.asarray([2.2, 0.0]), jnp.pi / 4,
                                   jnp.asarray([1.0, 0.5])))


def test_obb_overlap_rotation_separates():
    """Thin boxes crossing only when oriented toward each other."""
    a_c = jnp.asarray([0.0, 0.0])
    b_c = jnp.asarray([0.0, 1.2])
    half = jnp.asarray([2.0, 0.1])
    # parallel thin boxes, 1.2 apart: no overlap
    assert not bool(co.obb_overlap(a_c, 0.0, half, b_c, 0.0, half))
    # second box rotated 90 deg: reaches down and overlaps
    assert bool(co.obb_overlap(a_c, 0.0, half, b_c, jnp.pi / 2, half))


def test_obb_segment_overlap():
    center = jnp.asarray([0.0, 0.0])
    half = jnp.asarray([1.0, 0.5])
    # crossing segment
    assert bool(co.obb_segment_overlap(center, 0.0, half,
                                       jnp.asarray([-2.0, 0.0]),
                                       jnp.asarray([2.0, 0.0])))
    # segment passing clear above
    assert not bool(co.obb_segment_overlap(center, 0.0, half,
                                           jnp.asarray([-2.0, 1.0]),
                                           jnp.asarray([2.0, 1.0])))
    # diagonal segment clipping a corner
    assert bool(co.obb_segment_overlap(center, 0.0, half,
                                       jnp.asarray([0.8, 1.0]),
                                       jnp.asarray([1.5, -1.0])))


def test_merge_obb_pairs_covers_both():
    """The merged OBB contains the corners of both source boxes."""
    center = jnp.asarray([[[0.0, 0.0], [2.0, 0.5]]])       # [1, 2, 2]
    theta = jnp.asarray([[0.0, 0.4]])
    half = jnp.asarray([[1.0, 0.5]])
    c_m, t_m, h_m = co.merge_obb_pairs(center, theta, half)

    # corners of both boxes, projected into the merged frame, must lie inside
    for i in range(2):
        ct, th = np.asarray(center)[0, i], float(np.asarray(theta)[0, i])
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        corners = (np.array([[1, 0.5], [-1, 0.5], [-1, -0.5], [1, -0.5]]) @ rot.T
                   + ct)
        th_m = float(np.asarray(t_m)[0, 0])
        rot_m = np.array([[np.cos(th_m), -np.sin(th_m)],
                          [np.sin(th_m), np.cos(th_m)]])
        local = (corners - np.asarray(c_m)[0, 0]) @ rot_m
        assert np.all(np.abs(local[:, 0]) <= float(h_m[0, 0, 0]) + 1e-6)
        assert np.all(np.abs(local[:, 1]) <= float(h_m[0, 0, 1]) + 1e-6)


def test_continuous_catches_tunneling():
    """A fast crossing obstacle missed by the discrete check is caught by the
    swept check."""
    T = 3
    # ego stationary at origin
    x = jnp.zeros((1, T))
    y = jnp.zeros((1, T))
    theta = jnp.zeros((1, T))
    # obstacle jumps across the ego between steps 0 and 1 (tunneling)
    pose = np.zeros((1, T, 3))
    pose[0, :, 0] = [-10.0, 10.0, 30.0]
    obstacles = co.ObstacleArrays(pose=jnp.asarray(pose),
                                  half_ext=jnp.asarray([[2.0, 1.0]]),
                                  valid=jnp.ones((1, T), dtype=bool))
    half_l, half_w, wb = jnp.asarray(2.0), jnp.asarray(1.0), jnp.asarray(0.0)

    discrete = co.check_collisions(x, y, theta, obstacles, None,
                                   half_l, half_w, wb)
    swept = co.check_collisions_continuous(x, y, theta, obstacles,
                                           half_l, half_w, wb)
    assert not bool(discrete[0])
    assert bool(swept[0])


def test_corridor_band_check():
    """Synthetic straight road: candidates beyond the band collide."""
    from commonroad_rp_jax.ops import frenet
    line = np.stack([np.linspace(0, 100, 101), np.zeros(101)], axis=1)
    tables = frenet.from_polyline(line)
    corridor = co.CorridorArrays(d_lo=jnp.full(101, -3.0),
                                 d_hi=jnp.full(101, 3.0))
    s = jnp.asarray([[10.0, 20.0, 30.0]])
    theta_cl = jnp.zeros((1, 3))
    half_l, half_w, wb = jnp.asarray(2.25), jnp.asarray(0.8), jnp.asarray(1.42)

    inside = co.check_corridor(s, jnp.asarray([[0.0, 1.0, -1.0]]), theta_cl,
                               tables.s, corridor, half_l, half_w, wb)
    outside = co.check_corridor(s, jnp.asarray([[0.0, 1.0, 2.7]]), theta_cl,
                                tables.s, corridor, half_l, half_w, wb)
    assert not bool(inside[0])
    assert bool(outside[0])


def test_corridor_compile_straight_road():
    """compile_corridor recovers the band width of a straight two-edge road."""
    from commonroad_rp_jax.ops import frenet
    line = np.stack([np.linspace(0, 50, 51), np.zeros(51)], axis=1)
    tables = frenet.from_polyline(line)
    # boundary: two lines at y = +/- 4
    xs = np.linspace(-5, 55, 61)
    segs = []
    for yv in (4.0, -4.0):
        pts = np.stack([xs, np.full_like(xs, yv)], axis=1)
        segs.extend(np.stack([pts[:-1], pts[1:]], axis=1))
    boundary = co.BoundaryArrays(segments=jnp.asarray(np.stack(segs)),
                                 valid=jnp.ones(len(segs), dtype=bool))
    corridor = co.compile_corridor(boundary, tables)
    np.testing.assert_allclose(np.asarray(corridor.d_hi), 4.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(corridor.d_lo), -4.0, atol=1e-9)


def test_quantize_bands_contract():
    """Bands become multiples of 2**-10 in [-32, 32], only ever shrinking
    the drivable band (floor on d_hi, ceil on d_lo)."""
    rng = np.random.default_rng(4)
    d_lo = np.concatenate([rng.uniform(-40.0, -0.5, 100), [-1e4, -1e9]])
    d_hi = np.concatenate([rng.uniform(0.5, 40.0, 100), [1e4, 1e9]])
    lo_q, hi_q = co.quantize_bands(d_lo, d_hi)
    assert np.all(np.abs(lo_q) <= co.BAND_CLAMP)
    assert np.all(np.abs(hi_q) <= co.BAND_CLAMP)
    np.testing.assert_array_equal(lo_q * 1024.0, np.round(lo_q * 1024.0))
    np.testing.assert_array_equal(hi_q * 1024.0, np.round(hi_q * 1024.0))
    assert np.all(hi_q <= np.clip(d_hi, -co.BAND_CLAMP, co.BAND_CLAMP))
    assert np.all(lo_q >= np.clip(d_lo, -co.BAND_CLAMP, co.BAND_CLAMP))


def test_corridor_probes_clamp_to_true_path_end():
    """With sentinel rows past the path end (fleet padding, unbounded
    bands), probes clamped at ``s_last`` read the last real band — the
    same verdicts as the unpadded table."""
    ref_s = jnp.asarray([0.0, 10.0, 20.0, 30.0])
    corr = co.CorridorArrays(d_lo=jnp.full(4, -2.0), d_hi=jnp.full(4, 2.0))
    pad_s = jnp.concatenate([ref_s, 30.0 + 1e6 * jnp.arange(1.0, 3.0)])
    pad = co.CorridorArrays(
        d_lo=jnp.concatenate([corr.d_lo, jnp.full(2, -1e4)]),
        d_hi=jnp.concatenate([corr.d_hi, jnp.full(2, 1e4)]))
    # rear-axle stations near and past the end, lateral offsets 0 and 3 m
    s = jnp.asarray([[28.0, 29.5], [31.0, 33.0], [28.0, 29.5], [31.0, 33.0]])
    d = jnp.asarray([[0.0, 0.0], [0.0, 0.0], [3.0, 3.0], [3.0, 3.0]])
    theta = jnp.zeros_like(s)
    args = (jnp.asarray(2.0), jnp.asarray(0.8), jnp.asarray(1.4))
    want = co.check_corridor(s, d, theta, ref_s, corr, *args)
    got = co.check_corridor(s, d, theta, pad_s, pad, *args,
                            s_last=jnp.asarray(30.0))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want), [False, False, True, True])
