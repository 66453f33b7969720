"""ctypes bindings for the C++ host-geometry module.

The reference's genuinely native components (pycrccosy CLCS, pycrcc scene/
boundary primitives, trajectory_preprocess_obb_sum — SURVEY.md section 2.2)
have C++ host equivalents in ``src/crp_native.cpp``; this package loads them
through a plain C ABI.  Every entry point has a numpy fallback elsewhere in
the library, so the native module is an accelerator for host-side scene
compilation, not a hard dependency.

The library is not shipped prebuilt: the first use compiles it from the
source beside this file (``build()``, or ``make -C commonroad_rp_jax/native``
by hand) into ``libcrp_native.so`` here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libcrp_native.so")
_SRC_PATH = os.path.join(_DIR, "src", "crp_native.cpp")
_lib: Optional[ctypes.CDLL] = None
# whether this process compiled the library (vs. found it built)
built_here = False

_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def build(force: bool = False) -> bool:
    """Compile the native library from source; returns availability.

    The compiler writes a temporary file that is renamed into place, so
    processes that build at the same time never load a partial library.
    """
    global built_here
    if os.path.exists(_LIB_PATH) and not force:
        return True
    cxx = os.environ.get("CXX", "g++")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                        tmp, _SRC_PATH], check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        built_here = True
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.clcs_build_tables.argtypes = [_f64p, ctypes.c_int64, _f64p, _f64p,
                                      _f64p, _f64p]
    lib.clcs_project.argtypes = [_f64p, _f64p, _f64p, _f64p, ctypes.c_int64,
                                 _f64p, ctypes.c_int64, _f64p, _f64p]
    lib.clcs_project.restype = ctypes.c_int64
    lib.clcs_to_cartesian.argtypes = [_f64p, _f64p, _f64p, _f64p,
                                      ctypes.c_int64, _f64p, _f64p,
                                      ctypes.c_int64, _f64p]
    lib.scene_points_in_polygon.argtypes = [_f64p, ctypes.c_int64, _f64p,
                                            ctypes.c_int64, _u8p]
    lib.scene_corridor_sweep.argtypes = [_f64p, _f64p, ctypes.c_int64, _f64p,
                                         ctypes.c_int64, ctypes.c_double,
                                         _f64p, _f64p]
    lib.scene_obb_sum.argtypes = [_f64p, _f64p, ctypes.c_int64,
                                  ctypes.c_double, ctypes.c_double,
                                  _f64p, _f64p, _f64p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_f64p)


def clcs_build_tables(points: np.ndarray):
    """(s, theta_unwrapped, tangent, normal) tables for an [n, 2] polyline."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    points = np.ascontiguousarray(points, dtype=np.float64)
    n = len(points)
    s = np.empty(n)
    theta = np.empty(n)
    tangent = np.empty((n, 2))
    normal = np.empty((n, 2))
    lib.clcs_build_tables(_ptr(points), n, _ptr(s), _ptr(theta),
                          _ptr(tangent), _ptr(normal))
    return s, theta, tangent, normal


def clcs_project(points, s, tangent, normal,
                 query: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Project [m, 2] Cartesian points -> (s[m], d[m], n_inside_domain)."""
    lib = _load()
    assert lib is not None
    points = np.ascontiguousarray(points, dtype=np.float64)
    s = np.ascontiguousarray(s, dtype=np.float64)
    tangent = np.ascontiguousarray(tangent, dtype=np.float64)
    normal = np.ascontiguousarray(normal, dtype=np.float64)
    query = np.ascontiguousarray(np.atleast_2d(query), dtype=np.float64)
    m = len(query)
    s_out = np.empty(m)
    d_out = np.empty(m)
    inside = lib.clcs_project(_ptr(points), _ptr(s), _ptr(tangent),
                              _ptr(normal), len(points), _ptr(query), m,
                              _ptr(s_out), _ptr(d_out))
    return s_out, d_out, int(inside)


def clcs_to_cartesian(points, s, tangent, normal, s_in, d_in) -> np.ndarray:
    """Convert (s[m], d[m]) -> [m, 2] Cartesian; NaN outside the domain."""
    lib = _load()
    assert lib is not None
    points = np.ascontiguousarray(points, dtype=np.float64)
    s = np.ascontiguousarray(s, dtype=np.float64)
    tangent = np.ascontiguousarray(tangent, dtype=np.float64)
    normal = np.ascontiguousarray(normal, dtype=np.float64)
    s_in = np.ascontiguousarray(np.atleast_1d(s_in), dtype=np.float64)
    d_in = np.ascontiguousarray(np.atleast_1d(d_in), dtype=np.float64)
    out = np.empty((len(s_in), 2))
    lib.clcs_to_cartesian(_ptr(points), _ptr(s), _ptr(tangent), _ptr(normal),
                          len(points), _ptr(s_in), _ptr(d_in), len(s_in),
                          _ptr(out))
    return out


def points_in_polygon(polygon: np.ndarray, points: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    polygon = np.ascontiguousarray(polygon, dtype=np.float64)
    points = np.ascontiguousarray(np.atleast_2d(points), dtype=np.float64)
    out = np.empty(len(points), dtype=np.uint8)
    lib.scene_points_in_polygon(_ptr(polygon), len(polygon), _ptr(points),
                                len(points), out.ctypes.data_as(_u8p))
    return out.astype(bool)


def corridor_sweep(path_points: np.ndarray, normals: np.ndarray,
                   segments: np.ndarray, d_default: float = 1e4):
    """(d_lo[P], d_hi[P]) drivable band via normal/segment intersections."""
    lib = _load()
    assert lib is not None
    path_points = np.ascontiguousarray(path_points, dtype=np.float64)
    normals = np.ascontiguousarray(normals, dtype=np.float64)
    segments = np.ascontiguousarray(segments, dtype=np.float64)
    P = len(path_points)
    d_lo = np.empty(P)
    d_hi = np.empty(P)
    lib.scene_corridor_sweep(_ptr(path_points), _ptr(normals), P,
                             _ptr(segments), len(segments),
                             ctypes.c_double(d_default), _ptr(d_lo), _ptr(d_hi))
    return d_lo, d_hi


def obb_sum(centers: np.ndarray, thetas: np.ndarray, half_l: float,
            half_w: float):
    """Swept OBB covers of consecutive pose pairs
    (trajectory_preprocess_obb_sum equivalent)."""
    lib = _load()
    assert lib is not None
    centers = np.ascontiguousarray(centers, dtype=np.float64)
    thetas = np.ascontiguousarray(thetas, dtype=np.float64)
    t_len = len(thetas)
    out_c = np.empty((t_len - 1, 2))
    out_t = np.empty(t_len - 1)
    out_h = np.empty((t_len - 1, 2))
    lib.scene_obb_sum(_ptr(centers), _ptr(thetas), t_len,
                      ctypes.c_double(half_l), ctypes.c_double(half_w),
                      _ptr(out_c), _ptr(out_t), _ptr(out_h))
    return out_c, out_t, out_h
