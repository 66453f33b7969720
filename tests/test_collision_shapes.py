"""Exact circle/polygon obstacle collision (shape-fidelity kernels).

pycrcc collides exact shape primitives (reference:
commonroad_rp/reactive_planner.py:236-239 via create_collision_object);
round 1 over-approximated circle -> square OBB and polygon -> AABB.  These
tests pin the exact semantics:

* hand-built corner cases where the old over-approximation and the exact
  test DISAGREE (the over-approximation would reject valid trajectories),
* randomized sweeps against an independent dense-sampling oracle,
* concave-polygon decomposition correctness (notch region is free space),
* scenario-level integration through compile_obstacles,
* Fused-scorer fast-path parity for disc obstacles.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from commonroad_rp_jax.ops import collision as co


def _ego(x, y, theta):
    """Single-pose ego trajectory arrays [K=1, T=1]."""
    return (jnp.asarray([[x]]), jnp.asarray([[y]]), jnp.asarray([[theta]]))


def _disc_scene(cx, cy, r, T=1):
    return co.ObstacleArrays(
        pose=jnp.asarray(np.tile([cx, cy, 0.0], (1, T, 1))),
        half_ext=jnp.zeros((1, 2)),
        valid=jnp.ones((1, T), dtype=bool),
        radius=jnp.asarray([r]))


def _square_scene(cx, cy, r, T=1):
    """The round-1 over-approximation of the same disc: an r x r square OBB."""
    return co.ObstacleArrays(
        pose=jnp.asarray(np.tile([cx, cy, 0.0], (1, T, 1))),
        half_ext=jnp.asarray([[r, r]]),
        valid=jnp.ones((1, T), dtype=bool))


def _check(scene, x=0.0, y=0.0, theta=0.0, hl=1.0, hw=0.5):
    hit = co.check_collisions(*_ego(x, y, theta), scene, None,
                              jnp.asarray(hl), jnp.asarray(hw),
                              jnp.asarray(0.0))
    return bool(np.asarray(hit)[0])


# ---------------------------------------------------------------------------
# disc vs OBB
# ---------------------------------------------------------------------------

def test_disc_corner_exact_vs_square_overapprox():
    """Disc near the box corner: inside the bounding square's reach but
    outside the true radius — exact says free, the old square OBB said hit."""
    # ego box corner at (1.0, 0.5); disc center on the corner diagonal
    r = 1.0
    d = (r + 0.2) / np.sqrt(2.0)
    center = (1.0 + d, 0.5 + d)
    assert not _check(_disc_scene(*center, r))              # exact: free
    assert _check(_square_scene(*center, r))                # over-approx: hit


def test_disc_face_contact_hits():
    """Disc straight off a box face within the radius must hit on both."""
    assert _check(_disc_scene(1.0 + 0.9, 0.0, 1.0))
    assert _check(_square_scene(1.0 + 0.9, 0.0, 1.0))


def test_disc_inside_box_hits():
    assert _check(_disc_scene(0.2, 0.1, 0.05))


def test_disc_rotated_ego():
    """Exactness holds for a rotated ego box (clamp happens in its frame)."""
    theta = np.pi / 4
    # corner of the rotated box: along the rotated major axis
    cx = (1.0 + 0.5) * np.cos(theta)
    cy = (1.0 + 0.5) * np.sin(theta)
    assert _check(_disc_scene(cx, cy, 0.6), theta=theta)
    # beyond the radius past the corner: free
    cx2 = (1.0 + 1.2) * np.cos(theta)
    cy2 = (1.0 + 1.2) * np.sin(theta)
    assert not _check(_disc_scene(cx2, cy2, 0.6), theta=theta)


def test_disc_randomized_vs_sampling_oracle():
    """Randomized disc-vs-OBB sweep against a dense point-sampling oracle."""
    rng = np.random.default_rng(7)
    hl, hw = 1.4, 0.6
    # dense grid over the ego box in its body frame
    gx, gy = np.meshgrid(np.linspace(-hl, hl, 160), np.linspace(-hw, hw, 80))
    n_checked = 0
    for _ in range(300):
        theta = rng.uniform(-np.pi, np.pi)
        ex, ey = rng.uniform(-2, 2, size=2)
        c = rng.uniform(-4, 4, size=2)
        r = rng.uniform(0.1, 1.5)
        # world-frame box sample points
        ct, st = np.cos(theta), np.sin(theta)
        px = ex + ct * gx - st * gy
        py = ey + st * gx + ct * gy
        dist_min = np.sqrt((px - c[0]) ** 2 + (py - c[1]) ** 2).min()
        margin = abs(dist_min - r)
        if margin < 0.05:         # boundary case: sampling oracle unreliable
            continue
        n_checked += 1
        want = dist_min <= r
        got = _check(_disc_scene(c[0], c[1], r), x=ex, y=ey, theta=theta,
                     hl=hl, hw=hw)
        assert got == want, (theta, ex, ey, c, r, dist_min)
    assert n_checked > 200


# ---------------------------------------------------------------------------
# convex polygon vs OBB
# ---------------------------------------------------------------------------

def _poly_scene(verts, T=1):
    verts = np.asarray(verts, dtype=np.float64)
    return co.ObstacleArrays(
        pose=jnp.zeros((0, T, 3)), half_ext=jnp.zeros((0, 2)),
        valid=jnp.zeros((0, T), dtype=bool),
        poly_verts=jnp.asarray(np.tile(verts[None, None], (1, T, 1, 1))),
        poly_valid=jnp.ones((1, T), dtype=bool))


def test_triangle_hypotenuse_vs_aabb_overapprox():
    """Box near a triangle's hypotenuse: inside the triangle's AABB but
    outside the triangle — exact SAT must report free."""
    tri = [[2.0, 0.0], [6.0, 0.0], [2.0, 4.0]]
    # small ego box in the AABB's empty half, beyond the hypotenuse
    assert not _check(_poly_scene(tri), x=5.2, y=3.2, hl=0.4, hw=0.4)
    # the old AABB over-approximation (halves (2, 2) at center (4, 2)):
    assert _check(_square_scene(4.0, 2.0, 2.0), x=5.2, y=3.2, hl=0.4, hw=0.4)
    # box genuinely touching the triangle: hit
    assert _check(_poly_scene(tri), x=3.0, y=1.0, hl=0.4, hw=0.4)


def test_polygon_contains_box():
    big = [[-5, -5], [5, -5], [5, 5], [-5, 5]]
    assert _check(_poly_scene(big), x=0.0, y=0.0)


def test_box_contains_polygon():
    tiny = [[-0.1, -0.1], [0.1, -0.1], [0.0, 0.1]]
    assert _check(_poly_scene(tiny), x=0.0, y=0.0)


def test_polygon_padded_vertices_no_false_separation():
    """V-padding repeats the last vertex; degenerate edges must not create
    a phantom separating axis (triangle padded to V=6)."""
    tri = np.asarray([[2.0, 0.0], [6.0, 0.0], [2.0, 4.0]])
    padded = np.concatenate([tri, np.repeat(tri[-1:], 3, axis=0)])
    assert _check(_poly_scene(padded), x=3.0, y=1.0, hl=0.4, hw=0.4)
    assert not _check(_poly_scene(padded), x=5.2, y=3.2, hl=0.4, hw=0.4)


def test_polygon_randomized_vs_sampling_oracle():
    """Random convex polygons vs random ego OBBs against a sampling oracle:
    sample both shapes densely; overlap iff some box point is in the polygon
    or some polygon point is in the box (sufficient at this density given
    the margin guard)."""
    from commonroad_rp_jax.utils.scenario import point_in_polygon

    rng = np.random.default_rng(11)
    hl, hw = 1.0, 0.5
    gx, gy = np.meshgrid(np.linspace(-hl, hl, 60), np.linspace(-hw, hw, 30))
    n_checked = 0
    for _ in range(120):
        # random convex polygon: hull of random points
        raw = rng.uniform(-2, 2, size=(8, 2)) + rng.uniform(-3, 3, size=2)
        hull = _convex_hull(raw)
        if len(hull) < 3:
            continue
        theta = rng.uniform(-np.pi, np.pi)
        ex, ey = rng.uniform(-3, 3, size=2)
        ct, st = np.cos(theta), np.sin(theta)
        px = (ex + ct * gx - st * gy).ravel()
        py = (ey + st * gx + ct * gy).ravel()
        box_pts_in_poly = any(point_in_polygon(np.array([x, y]), hull)
                              for x, y in zip(px[::7], py[::7]))
        # polygon boundary+interior samples tested against the box
        poly_samples = _polygon_samples(hull, rng, 400)
        rel = poly_samples - np.array([ex, ey])
        lx = np.abs(rel[:, 0] * ct + rel[:, 1] * st)
        ly = np.abs(-rel[:, 0] * st + rel[:, 1] * ct)
        poly_pts_in_box = bool(np.any((lx <= hl) & (ly <= hw)))
        want = box_pts_in_poly or poly_pts_in_box
        got = _check(_poly_scene(hull), x=ex, y=ey, theta=theta, hl=hl, hw=hw)
        # sampling only proves overlap, not separation: require agreement
        # when the oracle found an overlapping point; when it found none,
        # allow got=True only for thin contact (skip ambiguous cases by
        # re-testing with a slightly shrunk box)
        if want:
            assert got, (hull, ex, ey, theta)
            n_checked += 1
        else:
            if got:
                shrunk = _check(_poly_scene(hull), x=ex, y=ey, theta=theta,
                                hl=hl * 0.9, hw=hw * 0.9)
                # near-boundary contact: tolerated; a *shrunk* box must agree
                # with the oracle unless the contact region is very thin
                if shrunk:
                    # verify with a much denser oracle before failing
                    dense = _polygon_samples(hull, rng, 20000)
                    rel = dense - np.array([ex, ey])
                    lx = np.abs(rel[:, 0] * ct + rel[:, 1] * st)
                    ly = np.abs(-rel[:, 0] * st + rel[:, 1] * ct)
                    assert bool(np.any((lx <= hl) & (ly <= hw))), \
                        (hull, ex, ey, theta)
            n_checked += 1
    assert n_checked > 60


def _convex_hull(points):
    """Andrew monotone chain (independent of the library's geometry code)."""
    pts = sorted(map(tuple, points))
    if len(pts) <= 2:
        return np.asarray(pts)

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                o, a = out[-2], out[-1]
                if (a[0] - o[0]) * (p[1] - o[1]) - \
                        (a[1] - o[1]) * (p[0] - o[0]) <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(pts)
    upper = half(reversed(pts))
    return np.asarray(lower[:-1] + upper[:-1])


def _polygon_samples(hull, rng, n):
    """Uniform samples inside a convex polygon (fan triangulation)."""
    hull = np.asarray(hull)
    tris = [(hull[0], hull[i], hull[i + 1]) for i in range(1, len(hull) - 1)]
    areas = np.array([abs((b[0] - a[0]) * (c[1] - a[1]) -
                          (b[1] - a[1]) * (c[0] - a[0])) / 2 for a, b, c in tris])
    if areas.sum() == 0:
        return hull.copy()
    probs = areas / areas.sum()
    idx = rng.choice(len(tris), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    pts = np.array([tris[i] for i in idx])         # [n, 3, 2]
    a, b, c = pts[:, 0], pts[:, 1], pts[:, 2]
    return (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + \
        (r1 * r2)[:, None] * c


# ---------------------------------------------------------------------------
# concave polygons (host decomposition)
# ---------------------------------------------------------------------------

def test_concave_notch_is_free_space():
    """L-shaped obstacle: a box inside the notch (inside AABB and convex
    hull!) must be collision-free; a box on the L itself must hit."""
    L = [[0, 0], [4, 0], [4, 1], [1, 1], [1, 4], [0, 4]]
    from commonroad_rp_jax.utils.geometry import decompose_polygon
    pieces = decompose_polygon(np.asarray(L, dtype=np.float64))
    assert len(pieces) >= 2
    V = max(len(p) for p in pieces)
    T = 1
    verts = np.stack([np.concatenate(
        [p, np.repeat(p[-1:], V - len(p), axis=0)]) for p in pieces])
    scene = co.ObstacleArrays(
        pose=jnp.zeros((0, T, 3)), half_ext=jnp.zeros((0, 2)),
        valid=jnp.zeros((0, T), dtype=bool),
        poly_verts=jnp.asarray(verts[:, None]),
        poly_valid=jnp.ones((len(pieces), T), dtype=bool))
    # notch interior (2.5, 2.5) — far from both arms
    assert not _check(scene, x=2.5, y=2.5, hl=0.5, hw=0.5)
    # on the bottom arm
    assert _check(scene, x=2.0, y=0.5, hl=0.5, hw=0.5)
    # on the left arm
    assert _check(scene, x=0.5, y=3.0, hl=0.5, hw=0.5)


# ---------------------------------------------------------------------------
# continuous (swept) mode
# ---------------------------------------------------------------------------

def test_continuous_disc_covering_obb():
    """Swept mode encloses disc pairs in covering OBBs (obb-sum semantics):
    an ego passing between two disc steps must be flagged."""
    T = 2
    pose = np.zeros((1, T, 3))
    pose[0, 0] = [0.0, 3.0, 0.0]
    pose[0, 1] = [8.0, 3.0, 0.0]
    scene = co.ObstacleArrays(
        pose=jnp.asarray(pose), half_ext=jnp.zeros((1, 2)),
        valid=jnp.ones((1, T), dtype=bool), radius=jnp.asarray([1.0]))
    # ego sits at (4, 3) both steps: between the two discs — discrete test
    # misses it, the swept covering OBB catches it
    x = jnp.asarray([[4.0, 4.0]])
    y = jnp.asarray([[3.0, 3.0]])
    theta = jnp.zeros((1, T))
    hl, hw, wb = jnp.asarray(1.0), jnp.asarray(0.5), jnp.asarray(0.0)
    assert not bool(np.asarray(
        co.check_collisions(x, y, theta, scene, None, hl, hw, wb))[0])
    assert bool(np.asarray(
        co.check_collisions_continuous(x, y, theta, scene, hl, hw, wb))[0])


def test_continuous_polygon_covering_box():
    T = 2
    tri0 = np.asarray([[0.0, 2.0], [1.0, 2.0], [0.5, 3.0]])
    tri1 = tri0 + np.array([6.0, 0.0])
    verts = np.stack([tri0, tri1])[None]           # [1, T, 3, 2]
    scene = co.ObstacleArrays(
        pose=jnp.zeros((0, T, 3)), half_ext=jnp.zeros((0, 2)),
        valid=jnp.zeros((0, T), dtype=bool),
        poly_verts=jnp.asarray(verts),
        poly_valid=jnp.ones((1, T), dtype=bool))
    x = jnp.asarray([[3.0, 3.0]])
    y = jnp.asarray([[2.5, 2.5]])
    theta = jnp.zeros((1, T))
    hl, hw, wb = jnp.asarray(0.5), jnp.asarray(0.5), jnp.asarray(0.0)
    assert not bool(np.asarray(
        co.check_collisions(x, y, theta, scene, None, hl, hw, wb))[0])
    assert bool(np.asarray(
        co.check_collisions_continuous(x, y, theta, scene, hl, hw, wb))[0])


# ---------------------------------------------------------------------------
# scenario integration + fast path parity
# ---------------------------------------------------------------------------

def test_compile_obstacles_disc_and_polygon_groups(tmp_path):
    """compile_obstacles routes shapes to the exact groups, including a
    DYNAMIC circle obstacle (moving disc)."""
    from commonroad_rp_jax.utils.scenario import (Circle, DynamicObstacle,
                                                  Polygon, Scenario,
                                                  StaticObstacle)
    from commonroad_rp_jax.models.state import TraceState

    states = [TraceState(time_step=t, position=np.array([2.0 * t, 0.0]),
                         orientation=0.0) for t in range(4)]
    disc = DynamicObstacle(obstacle_id=1, obstacle_type="car",
                           shape=Circle(radius=1.5),
                           initial_state=states[0], trajectory=states[1:])
    tri = StaticObstacle(obstacle_id=2, obstacle_type="unknown",
                         shape=Polygon(points=np.array(
                             [[10.0, 0.0], [14.0, 0.0], [10.0, 4.0]])),
                         initial_state=TraceState(
                             time_step=0, position=np.array([0.0, 0.0]),
                             orientation=0.0))
    from commonroad_rp_jax.utils.scenario import LaneletNetwork
    scenario = Scenario(scenario_id="SYN_Shapes-1", dt=0.1,
                        lanelet_network=LaneletNetwork([]),
                        static_obstacles=[tri], dynamic_obstacles=[disc])

    obstacles = co.compile_obstacles(scenario, 0, 3)
    assert np.asarray(obstacles.radius).tolist() == [1.5]
    np.testing.assert_allclose(np.asarray(obstacles.half_ext)[0], [0, 0])
    # moving disc: pose follows the trajectory
    np.testing.assert_allclose(np.asarray(obstacles.pose)[0, 2, :2], [4.0, 0.0])
    # static polygon: world verts constant over steps
    pv = np.asarray(obstacles.poly_verts)
    assert pv.shape == (1, 4, 3, 2)
    np.testing.assert_allclose(pv[0, 0], pv[0, 3])
    np.testing.assert_allclose(pv[0, 0, 1], [14.0, 0.0])


def test_fast_path_disc_parity_interpret():
    """The fused scorer must mask disc collisions exactly like
    the XLA path: candidates threading past the disc's corner gap survive."""
    import jax

    from commonroad_rp_jax.ops import cycle as cycle_ops
    from commonroad_rp_jax.ops import frenet as frenet_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.ops.polynomial import (quartic_coeffs,
                                                  quintic_coeffs)

    with jax.enable_x64(False):
        dtype = jnp.float32
        n = 200
        s_ref = np.linspace(0.0, 120.0, n)
        ref = frenet_ops.RefPathTables(
            points=jnp.asarray(np.stack([s_ref, np.zeros(n)], 1), dtype),
            s=jnp.asarray(s_ref, dtype), theta=jnp.zeros(n, dtype),
            curv=jnp.zeros(n, dtype), curv_d=jnp.zeros(n, dtype),
            curv_dd=jnp.zeros(n, dtype),
            tangent=jnp.asarray(np.tile([1.0, 0.0], (n, 1)), dtype),
            normal=jnp.asarray(np.tile([0.0, 1.0], (n, 1)), dtype))
        veh = kin_ops.VehicleArrays(
            wheelbase=dtype(2.5), wb_rear_axle=dtype(1.4), a_max=dtype(8.0),
            v_switch=dtype(7.3), kappa_max=dtype(0.2), v_delta_max=dtype(0.4),
            half_length=dtype(2.2), half_width=dtype(0.9))

        n_steps = 20
        dt = 0.1
        horizon = n_steps * dt
        # a fan of lateral end offsets around a disc parked at (18, 0)
        d_ends = np.linspace(-4.0, 4.0, 33)
        K = len(d_ends)
        c_lon = np.tile(np.asarray(
            quartic_coeffs(jnp.asarray([[0.0, 10.0, 0.0]]),
                           jnp.asarray([10.0]), jnp.asarray([horizon]))),
            (K, 1))
        x0_lat = np.zeros((K, 3))
        xd_lat = np.stack([d_ends, np.zeros(K), np.zeros(K)], axis=1)
        c_lat = np.asarray(
            quintic_coeffs(jnp.asarray(x0_lat), jnp.asarray(xd_lat),
                           jnp.full(K, horizon)))
        traj_len = jnp.full((K,), n_steps + 1, jnp.int32)

        obstacles = co.ObstacleArrays(
            pose=jnp.asarray(np.tile([18.0, 0.0, 0.0], (1, n_steps + 1, 1)),
                             dtype),
            half_ext=jnp.zeros((1, 2), dtype),
            valid=jnp.ones((1, n_steps + 1), dtype=bool),
            radius=jnp.asarray([1.2], dtype))
        corridor = co.CorridorArrays(d_lo=jnp.full((n,), -1e9, dtype),
                                     d_hi=jnp.full((n,), 1e9, dtype))
        cost_params = cycle_ops.CostParams(
            w_a=dtype(5.0), desired_d=dtype(0.0), desired_speed=dtype(10.0),
            desired_s=dtype(0.0))

        xla = cycle_ops.evaluate_level(
            jnp.asarray(c_lon, dtype), jnp.asarray(c_lat, dtype), traj_len,
            jnp.ones(K, dtype=bool), ref, veh, obstacles, None, corridor,
            dtype(0.0), cost_params, dt=dt, n_steps=n_steps,
            low_vel_mode=False, cost_structure=("default", True, False),
            constraint_flags=(True,) * 5, boundary_mode="corridor")
        fast = cycle_ops.evaluate_level_fast(
            jnp.asarray(c_lon, dtype), jnp.asarray(c_lat, dtype), traj_len,
            jnp.ones(K, dtype=bool), ref, veh, obstacles, corridor,
            dtype(0.0), cost_params, dt=dt, n_steps=n_steps,
            low_vel_mode=False, cost_structure=("default", True, False),
            constraint_flags=(True,) * 5)

        xla_collides = np.asarray(xla.masks)[1].astype(bool)
        xla_feasible = np.asarray(xla.masks)[0].astype(bool)
        fast_masked = np.asarray(fast.costs)
        # the disc must actually split the fan: some collide, some don't
        assert xla_collides.any() and not xla_collides.all()
        np.testing.assert_array_equal(
            np.isinf(fast_masked), ~(xla_feasible & ~xla_collides))
        assert int(np.asarray(xla.scalars)[0]) == int(np.asarray(fast.scalars)[0])


def test_fast_path_polygon_parity_interpret():
    """The fused scorer with a POLYGON obstacle group: masks match the XLA
    conformance path exactly (the same convex-piece SAT)."""
    import jax

    from commonroad_rp_jax.ops import cycle as cycle_ops
    from commonroad_rp_jax.ops import frenet as frenet_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.ops.polynomial import (quartic_coeffs,
                                                  quintic_coeffs)

    with jax.enable_x64(False):
        dtype = jnp.float32
        n = 200
        s_ref = np.linspace(0.0, 120.0, n)
        ref = frenet_ops.RefPathTables(
            points=jnp.asarray(np.stack([s_ref, np.zeros(n)], 1), dtype),
            s=jnp.asarray(s_ref, dtype), theta=jnp.zeros(n, dtype),
            curv=jnp.zeros(n, dtype), curv_d=jnp.zeros(n, dtype),
            curv_dd=jnp.zeros(n, dtype),
            tangent=jnp.asarray(np.tile([1.0, 0.0], (n, 1)), dtype),
            normal=jnp.asarray(np.tile([0.0, 1.0], (n, 1)), dtype))
        veh = kin_ops.VehicleArrays(
            wheelbase=dtype(2.5), wb_rear_axle=dtype(1.4), a_max=dtype(8.0),
            v_switch=dtype(7.3), kappa_max=dtype(0.2), v_delta_max=dtype(0.4),
            half_length=dtype(2.2), half_width=dtype(0.9))

        n_steps = 20
        dt = 0.1
        horizon = n_steps * dt
        d_ends = np.linspace(-4.0, 4.0, 33)
        K = len(d_ends)
        c_lon = np.tile(np.asarray(
            quartic_coeffs(jnp.asarray([[0.0, 10.0, 0.0]]),
                           jnp.asarray([10.0]), jnp.asarray([horizon]))),
            (K, 1))
        x0_lat = np.zeros((K, 3))
        xd_lat = np.stack([d_ends, np.zeros(K), np.zeros(K)], axis=1)
        c_lat = np.asarray(
            quintic_coeffs(jnp.asarray(x0_lat), jnp.asarray(xd_lat),
                           jnp.full(K, horizon)))
        traj_len = jnp.full((K,), n_steps + 1, jnp.int32)

        # a triangle parked near the lane, padded to V=5 (degenerate edges)
        tri = np.asarray([[16.0, -0.5], [20.0, -0.5], [18.0, 1.5]])
        padded = np.concatenate([tri, np.repeat(tri[-1:], 2, axis=0)])
        T = n_steps + 1
        obstacles = co.ObstacleArrays(
            pose=jnp.zeros((0, T, 3), dtype),
            half_ext=jnp.zeros((0, 2), dtype),
            valid=jnp.zeros((0, T), dtype=bool),
            poly_verts=jnp.asarray(np.tile(padded[None, None], (1, T, 1, 1)),
                                   dtype),
            poly_valid=jnp.ones((1, T), dtype=bool))
        corridor = co.CorridorArrays(d_lo=jnp.full((n,), -1e9, dtype),
                                     d_hi=jnp.full((n,), 1e9, dtype))
        cost_params = cycle_ops.CostParams(
            w_a=dtype(5.0), desired_d=dtype(0.0), desired_speed=dtype(10.0),
            desired_s=dtype(0.0))
        kwargs = dict(dt=dt, n_steps=n_steps, low_vel_mode=False,
                      cost_structure=("default", True, False),
                      constraint_flags=(True,) * 5)

        xla = cycle_ops.evaluate_level(
            jnp.asarray(c_lon, dtype), jnp.asarray(c_lat, dtype), traj_len,
            jnp.ones(K, dtype=bool), ref, veh, obstacles, None, corridor,
            dtype(0.0), cost_params, boundary_mode="corridor", **kwargs)
        fast = cycle_ops.evaluate_level_fast(
            jnp.asarray(c_lon, dtype), jnp.asarray(c_lat, dtype), traj_len,
            jnp.ones(K, dtype=bool), ref, veh, obstacles, corridor,
            dtype(0.0), cost_params, **kwargs)

        xla_collides = np.asarray(xla.masks)[1].astype(bool)
        xla_feasible = np.asarray(xla.masks)[0].astype(bool)
        fast_masked = np.asarray(fast.costs)
        assert xla_collides.any() and not xla_collides.all()
        np.testing.assert_array_equal(
            np.isinf(fast_masked), ~(xla_feasible & ~xla_collides))
        assert int(np.asarray(xla.scalars)[0]) == int(np.asarray(fast.scalars)[0])
