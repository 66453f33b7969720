"""Host polyline geometry utilities (equivalents of commonroad_dc.geometry.util)."""

import numpy as np

from commonroad_rp_jax.utils import geometry


def _circle_polyline(radius=50.0, n=200, span=np.pi / 2):
    angles = np.linspace(0.0, span, n)
    return np.stack([radius * np.sin(angles), radius * (1 - np.cos(angles))], axis=1)


def test_pathlength_straight_line():
    line = np.stack([np.linspace(0, 10, 11), np.zeros(11)], axis=1)
    s = geometry.compute_pathlength(line)
    np.testing.assert_allclose(s, np.linspace(0, 10, 11), atol=1e-12)


def test_pathlength_circle_arc():
    poly = _circle_polyline()
    s = geometry.compute_pathlength(poly)
    # chord-length approximation of the arc length R * span
    np.testing.assert_allclose(s[-1], 50.0 * np.pi / 2, rtol=1e-4)


def test_curvature_of_circle():
    poly = _circle_polyline()
    curv = geometry.compute_curvature(poly)
    # interior curvature ~ 1/R (left turn -> positive)
    np.testing.assert_allclose(curv[5:-5], 1.0 / 50.0, rtol=1e-2)


def test_orientation_straight_and_unwrapped():
    line = np.stack([np.linspace(0, 10, 11), np.linspace(0, 10, 11)], axis=1)
    theta = geometry.compute_orientation(line)
    np.testing.assert_allclose(theta, np.pi / 4, atol=1e-12)


def test_resample_fixed_step():
    poly = _circle_polyline()
    res = geometry.resample_polyline(poly, step=1.0)
    seg = np.linalg.norm(np.diff(res, axis=0), axis=1)
    assert np.all(seg[:-1] <= 1.0 + 1e-6)
    np.testing.assert_allclose(res[0], poly[0], atol=1e-12)
    np.testing.assert_allclose(res[-1], poly[-1], atol=1e-9)


def test_chaikin_preserves_endpoints_and_smooths():
    corner = np.array([[0.0, 0.0], [5.0, 0.0], [5.0, 5.0]])
    out = geometry.chaikins_corner_cutting(corner, refinements=3)
    np.testing.assert_allclose(out[0], corner[0])
    np.testing.assert_allclose(out[-1], corner[-1])
    assert len(out) > len(corner)
    # corner-cut polyline must stay inside the convex hull of the corner
    assert np.all(out[:, 0] <= 5.0 + 1e-9) and np.all(out[:, 1] <= 5.0 + 1e-9)


def test_preprocess_bounds_curvature():
    corner = np.array([[0.0, 0.0], [20.0, 0.0], [20.0, 20.0]])
    out = geometry.preprocess_ref_path(corner, resample_step=1.0, max_curv_desired=0.15)
    assert np.max(np.abs(geometry.compute_curvature(out))) <= 0.15 + 1e-9


def test_smooth_ref_path_stays_close():
    poly = _circle_polyline(n=40)
    smooth = geometry.smooth_ref_path(poly, smoothing_factor=0.0, resample_step=1.0)
    # spline interpolates with s=0: every smoothed point stays on the circle
    radii = np.linalg.norm(smooth - np.array([0.0, 50.0]), axis=1)
    np.testing.assert_allclose(radii, 50.0, atol=0.05)


def test_extrapolate_extends_path():
    line = np.stack([np.linspace(0, 10, 6), np.linspace(0, 5, 6)], axis=1)
    ext = geometry.extrapolate_ref_path(line, resample_step=2.0)
    assert geometry.compute_pathlength(ext)[-1] > geometry.compute_pathlength(line)[-1]
    # extension continues the final direction
    d_end = ext[-1] - ext[-2]
    np.testing.assert_allclose(np.arctan2(d_end[1], d_end[0]),
                               np.arctan2(5, 10), atol=1e-6)


def test_interpolate_angle_midpoint():
    got = geometry.interpolate_angle(0.5, 0.0, 1.0, 0.1, 0.3)
    np.testing.assert_allclose(got, 0.2, atol=1e-12)


def test_make_valid_orientation_wraps():
    assert abs(geometry.make_valid_orientation(7.0)) <= 2 * np.pi
    np.testing.assert_allclose(geometry.make_valid_orientation(2 * np.pi + 0.5), 0.5,
                               atol=1e-12)
    np.testing.assert_allclose(geometry.make_valid_orientation(-2 * np.pi - 0.5), -0.5,
                               atol=1e-12)


def test_remove_duplicate_vertices():
    poly = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    out = geometry.remove_duplicate_vertices(poly)
    assert len(out) == 3
    np.testing.assert_allclose(out[:, 0], [0.0, 1.0, 2.0])
