"""Native C++ host module vs. the numpy implementations."""

import numpy as np
import pytest

from commonroad_rp_jax import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library failed to build")


def _arc(radius=40.0, n=120):
    ang = np.linspace(0, np.pi / 2, n)
    return np.stack([radius * np.sin(ang), radius * (1 - np.cos(ang))], axis=1)


def test_tables_match_python():
    from commonroad_rp_jax.ops import frenet
    poly = _arc()
    s, theta, tangent, normal = native.clcs_build_tables(poly)
    tables = frenet.from_polyline(poly)
    np.testing.assert_allclose(s, np.asarray(tables.s), atol=1e-12)
    np.testing.assert_allclose(theta, np.asarray(tables.theta), atol=1e-9)
    np.testing.assert_allclose(tangent, np.asarray(tables.tangent), atol=1e-12)
    np.testing.assert_allclose(normal, np.asarray(tables.normal), atol=1e-12)


def test_projection_roundtrip():
    poly = _arc()
    s, theta, tangent, normal = native.clcs_build_tables(poly)
    queries = np.array([[20.0, 7.0], [30.0, 15.0]])
    s_out, d_out, inside = native.clcs_project(poly, s, tangent, normal, queries)
    assert inside == 2
    back = native.clcs_to_cartesian(poly, s, tangent, normal, s_out, d_out)
    np.testing.assert_allclose(back, queries, atol=1e-6)


def test_projection_matches_coordinate_system():
    from commonroad_rp_jax.utils.coordinate_system import CoordinateSystem
    poly = _arc()
    co = CoordinateSystem(poly, smooth_reference=False)
    # build the native tables from the SAME polyline the CoordinateSystem
    # projects onto (it prepends the CLCS front extension, which offsets s)
    s, theta, tangent, normal = native.clcs_build_tables(co.reference)
    q = np.array([[25.0, 9.0]])
    s_n, d_n, _ = native.clcs_project(co.reference, s, tangent, normal, q)
    sd = co.convert_to_curvilinear_coords(25.0, 9.0)
    np.testing.assert_allclose([s_n[0], d_n[0]], sd, atol=1e-9)


def test_points_in_polygon():
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], dtype=float)
    pts = np.array([[2, 2], [5, 2], [-1, -1], [3.9, 3.9]])
    got = native.points_in_polygon(square, pts)
    np.testing.assert_array_equal(got, [True, False, False, True])


def test_corridor_sweep_matches_python():
    import jax.numpy as jnp
    from commonroad_rp_jax.ops import collision as co
    from commonroad_rp_jax.ops import frenet

    line = np.stack([np.linspace(0, 50, 51), np.zeros(51)], axis=1)
    tables = frenet.from_polyline(line)
    xs = np.linspace(-5, 55, 61)
    segs = []
    for yv in (3.5, -2.5):
        pts = np.stack([xs, np.full_like(xs, yv)], axis=1)
        segs.extend(np.stack([pts[:-1], pts[1:]], axis=1))
    segments = np.stack(segs)

    d_lo, d_hi = native.corridor_sweep(np.asarray(tables.points),
                                       np.asarray(tables.normal), segments)
    boundary = co.BoundaryArrays(segments=jnp.asarray(segments),
                                 valid=jnp.ones(len(segments), dtype=bool))
    corridor = co.compile_corridor(boundary, tables)
    np.testing.assert_allclose(d_lo, np.asarray(corridor.d_lo), atol=1e-9)
    np.testing.assert_allclose(d_hi, np.asarray(corridor.d_hi), atol=1e-9)


def test_obb_sum_matches_device_merge():
    import jax.numpy as jnp
    from commonroad_rp_jax.ops import collision as co

    centers = np.array([[0.0, 0.0], [2.0, 0.5], [4.0, 1.5]])
    thetas = np.array([0.0, 0.3, 0.6])
    c_n, t_n, h_n = native.obb_sum(centers, thetas, 2.25, 0.8)

    c_d, t_d, h_d = co.merge_obb_pairs(jnp.asarray(centers[None]),
                                       jnp.asarray(thetas[None]),
                                       jnp.asarray([[2.25, 0.8]]))
    np.testing.assert_allclose(c_n, np.asarray(c_d)[0], atol=1e-9)
    np.testing.assert_allclose(t_n, np.asarray(t_d)[0], atol=1e-9)
    np.testing.assert_allclose(h_n, np.asarray(h_d)[0], atol=1e-9)
