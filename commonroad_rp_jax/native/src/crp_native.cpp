// Native host geometry kernels for the reactive planner.
//
// C++ counterpart of the reference's native dependencies (SURVEY.md §2.2):
// the pycrccosy CurvilinearCoordinateSystem construction + point projection
// (reference consumers: utils_coordinate_system.py:128, :167-178) and the
// scene-compilation geometry primitives behind the pycrcc road-boundary
// pipeline (reactive_planner.py:246-248): point-in-polygon batches and
// normal/segment intersection sweeps for the drivable-corridor tables.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// environment). All buffers are caller-allocated double arrays.

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// ---------------------------------------------------------------------------
// Curvilinear coordinate-system tables
// ---------------------------------------------------------------------------

// Build the per-vertex state tables of a reference polyline:
//   s         [n]   cumulative arclength
//   theta     [n]   unwrapped segment orientation (last repeats)
//   tangent   [n,2] unit segment tangent (last repeats)
//   normal    [n,2] unit left normal
// Curvature tables are computed by the Python layer (np.gradient semantics);
// this covers the geometric core the C++ CLCS provides.
void clcs_build_tables(const double* points, int64_t n,
                       double* s, double* theta,
                       double* tangent, double* normal) {
    s[0] = 0.0;
    for (int64_t i = 0; i + 1 < n; ++i) {
        const double dx = points[2 * (i + 1)] - points[2 * i];
        const double dy = points[2 * (i + 1) + 1] - points[2 * i + 1];
        const double len = std::sqrt(dx * dx + dy * dy);
        s[i + 1] = s[i] + len;
        const double inv = len > 0 ? 1.0 / len : 0.0;
        tangent[2 * i] = dx * inv;
        tangent[2 * i + 1] = dy * inv;
        theta[i] = std::atan2(dy, dx);
    }
    tangent[2 * (n - 1)] = tangent[2 * (n - 2)];
    tangent[2 * (n - 1) + 1] = tangent[2 * (n - 2) + 1];
    theta[n - 1] = theta[n - 2];
    // unwrap
    for (int64_t i = 1; i < n; ++i) {
        double d = theta[i] - theta[i - 1];
        while (d > M_PI) { theta[i] -= 2 * M_PI; d = theta[i] - theta[i - 1]; }
        while (d < -M_PI) { theta[i] += 2 * M_PI; d = theta[i] - theta[i - 1]; }
    }
    for (int64_t i = 0; i < n; ++i) {
        normal[2 * i] = -tangent[2 * i + 1];
        normal[2 * i + 1] = tangent[2 * i];
    }
}

// Orthogonal projection of m query points onto the polyline ->
// (s_out[m], d_out[m]). Returns the number of points whose projection falls
// strictly inside the table span (projection-domain check; the C++ CLCS
// throws outside, utils_coordinate_system.py:169-174).
int64_t clcs_project(const double* points, const double* s,
                     const double* tangent, const double* normal, int64_t n,
                     const double* query, int64_t m,
                     double* s_out, double* d_out) {
    int64_t inside = 0;
    for (int64_t q = 0; q < m; ++q) {
        const double px = query[2 * q], py = query[2 * q + 1];
        double best_d2 = std::numeric_limits<double>::infinity();
        double best_s = 0.0, best_d = 0.0;
        for (int64_t i = 0; i + 1 < n; ++i) {
            const double ax = points[2 * i], ay = points[2 * i + 1];
            const double tx = tangent[2 * i], ty = tangent[2 * i + 1];
            const double seg_len = s[i + 1] - s[i];
            double t = (px - ax) * tx + (py - ay) * ty;
            if (t < 0) t = 0;
            if (t > seg_len) t = seg_len;
            const double cx = ax + t * tx, cy = ay + t * ty;
            const double dx = px - cx, dy = py - cy;
            const double d2 = dx * dx + dy * dy;
            if (d2 < best_d2) {
                best_d2 = d2;
                best_s = s[i] + t;
                best_d = (px - ax) * normal[2 * i] + (py - ay) * normal[2 * i + 1];
            }
        }
        s_out[q] = best_s;
        d_out[q] = best_d;
        if (best_s > s[0] + 1e-9 && best_s < s[n - 1] - 1e-9) ++inside;
    }
    return inside;
}

// Frenet -> Cartesian batch conversion (segment-linear, matching
// ops.frenet.to_cartesian). Out-of-domain points get NaN coordinates.
void clcs_to_cartesian(const double* points, const double* s,
                       const double* tangent, const double* normal, int64_t n,
                       const double* s_in, const double* d_in, int64_t m,
                       double* xy_out) {
    for (int64_t q = 0; q < m; ++q) {
        const double sv = s_in[q];
        if (sv < s[0] || sv > s[n - 1]) {
            xy_out[2 * q] = std::numeric_limits<double>::quiet_NaN();
            xy_out[2 * q + 1] = std::numeric_limits<double>::quiet_NaN();
            continue;
        }
        // binary search for the segment
        int64_t lo = 0, hi = n - 1;
        while (hi - lo > 1) {
            const int64_t mid = (lo + hi) / 2;
            if (s[mid] <= sv) lo = mid; else hi = mid;
        }
        if (lo > n - 2) lo = n - 2;
        const double ds = sv - s[lo];
        xy_out[2 * q] = points[2 * lo] + ds * tangent[2 * lo]
                        + d_in[q] * normal[2 * lo];
        xy_out[2 * q + 1] = points[2 * lo + 1] + ds * tangent[2 * lo + 1]
                            + d_in[q] * normal[2 * lo + 1];
    }
}

// ---------------------------------------------------------------------------
// Scene-compilation primitives
// ---------------------------------------------------------------------------

// Ray-casting point-in-polygon for a batch of points against one polygon.
void scene_points_in_polygon(const double* poly, int64_t n_poly,
                             const double* pts, int64_t n_pts,
                             uint8_t* out) {
    for (int64_t q = 0; q < n_pts; ++q) {
        const double x = pts[2 * q], y = pts[2 * q + 1];
        bool in = false;
        int64_t j = n_poly - 1;
        for (int64_t i = 0; i < n_poly; ++i) {
            const double xi = poly[2 * i], yi = poly[2 * i + 1];
            const double xj = poly[2 * j], yj = poly[2 * j + 1];
            if ((yi > y) != (yj > y)) {
                const double x_cross = (xj - xi) * (y - yi) / (yj - yi) + xi;
                if (x < x_cross) in = !in;
            }
            j = i;
        }
        out[q] = in ? 1 : 0;
    }
}

// Drivable-corridor sweep: for each path vertex (point + left normal),
// intersect the normal line with every boundary segment and record the
// nearest positive / negative signed offsets (ops.collision.compile_corridor
// host math; the boundary-obstacle complement of the pycrcc pipeline).
void scene_corridor_sweep(const double* path_pts, const double* normals,
                          int64_t n_path,
                          const double* segments, int64_t n_segs,
                          double d_default,
                          double* d_lo, double* d_hi) {
    for (int64_t p = 0; p < n_path; ++p) {
        const double px = path_pts[2 * p], py = path_pts[2 * p + 1];
        const double nx = normals[2 * p], ny = normals[2 * p + 1];
        double hi = d_default, lo = -d_default;
        for (int64_t b = 0; b < n_segs; ++b) {
            const double ax = segments[4 * b], ay = segments[4 * b + 1];
            const double bx = segments[4 * b + 2], by = segments[4 * b + 3];
            const double ex = bx - ax, ey = by - ay;
            const double denom = nx * (-ey) - ny * (-ex);
            if (std::fabs(denom) < 1e-12) continue;
            const double apx = ax - px, apy = ay - py;
            const double t = (apx * (-ey) - apy * (-ex)) / denom;
            const double u = (nx * apy - ny * apx) / denom;
            if (u < -1e-9 || u > 1.0 + 1e-9) continue;
            if (t > 1e-9 && t < hi) hi = t;
            if (t < -1e-9 && t > lo) lo = t;
        }
        d_hi[p] = hi;
        d_lo[p] = lo;
    }
}

// Swept-OBB pair merge (trajectory_preprocess_obb_sum equivalent,
// reactive_planner.py:241): for T poses produce T-1 covering OBBs.
void scene_obb_sum(const double* centers, const double* thetas, int64_t t_len,
                   double half_l, double half_w,
                   double* out_centers, double* out_thetas,
                   double* out_half) {
    for (int64_t i = 0; i + 1 < t_len; ++i) {
        const double c0x = centers[2 * i], c0y = centers[2 * i + 1];
        const double c1x = centers[2 * i + 2], c1y = centers[2 * i + 3];
        const double t0 = thetas[i], t1 = thetas[i + 1];
        const double tm = std::atan2(std::sin(t0) + std::sin(t1),
                                     std::cos(t0) + std::cos(t1));
        const double cmx = 0.5 * (c0x + c1x), cmy = 0.5 * (c0y + c1y);
        const double ux = std::cos(tm), uy = std::sin(tm);
        const double vx = -uy, vy = ux;
        double h_major = 0.0, h_minor = 0.0;
        const double cs[2][2] = {{c0x, c0y}, {c1x, c1y}};
        const double ts[2] = {t0, t1};
        for (int k = 0; k < 2; ++k) {
            const double dt = ts[k] - tm;
            const double r_major = half_l * std::fabs(std::cos(dt))
                                   + half_w * std::fabs(std::sin(dt));
            const double r_minor = half_l * std::fabs(std::sin(dt))
                                   + half_w * std::fabs(std::cos(dt));
            const double ox = cs[k][0] - cmx, oy = cs[k][1] - cmy;
            const double om = std::fabs(ox * ux + oy * uy);
            const double on = std::fabs(ox * vx + oy * vy);
            if (om + r_major > h_major) h_major = om + r_major;
            if (on + r_minor > h_minor) h_minor = on + r_minor;
        }
        out_centers[2 * i] = cmx;
        out_centers[2 * i + 1] = cmy;
        out_thetas[i] = tm;
        out_half[2 * i] = h_major;
        out_half[2 * i + 1] = h_minor;
    }
}

}  // extern "C"
