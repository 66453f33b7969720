"""The Triton-route fleet scorer (ops.triton_scorer) in interpret mode on
the CPU against the XLA fleet scorer (ops.cycle.score_fleet): the same three
rows on a sentinel-padded mixed fleet of all four bundled scenarios, at the
bundled 2 s horizon and the reference's 6 s default; the wrapper's padding
of the candidate axis and its scope check."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cycle as cycle_ops
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import triton_scorer
from commonroad_rp_jax.parallel import fleet as fleet_ops
from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
from commonroad_rp_jax.utils.route import RoutePlanner

SCENARIOS = ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
             "ZAM_Tjunction-1_42_T-1")


def _fleet_args(repo_root, n_steps, level, stopping=False):
    dt, dtype = 0.1, jnp.float32
    problems = []
    for name in SCENARIOS:
        scenario, pp, _ = load_scenario_and_planning_problem(
            str(repo_root / "example_scenarios" / f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        problems.append(fleet_ops.problem_from_planner_setup(
            scenario, pp, route.reference_path, n_steps=n_steps,
            horizon_pad=10, dtype=dtype))
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps, dtype=dtype)
    F, T = len(problems), n_steps + 1
    grid = grid_ops.make_static_grid(level, 0.4, n_steps * dt, dt, -3.0,
                                     3.0, 4)
    low_vel = carry.velocity < 4.0
    if stopping:
        s0 = carry.x0_lon[:, 0]
        cands = [grid_ops.stopping_candidates(
            carry.x0_lon[f], carry.x0_lat[f], s0[f] + 5.0, s0[f] + 9.0,
            low_vel[f], grid) for f in range(F)]
        gv = jnp.stack([c[3] for c in cands])
    else:
        v_min = jnp.maximum(0.0, carry.velocity - 1.0)
        cands = [grid_ops.velocity_keeping_candidates(
            carry.x0_lon[f], carry.x0_lat[f], v_min[f], v_min[f] + 5.0,
            low_vel[f], grid) for f in range(F)]
    cl, ca, tl = (jnp.stack([c[i] for c in cands]) for i in range(3))
    if not stopping:
        gv = jnp.ones(tl.shape, dtype=bool)
    s = scene.ref.s
    ref_s_last = jnp.max(jnp.where(s < s[:, :1] + 5e5, s, -jnp.inf), axis=1)
    cost_params = cycle_ops.CostParams(
        w_a=jnp.full(F, 1.0 if stopping else 5.0, dtype),
        desired_d=jnp.zeros(F, dtype), desired_speed=scene.desired_speed,
        desired_s=carry.x0_lon[:, 0] + 7.0)
    obstacles = collision_ops.ObstacleArrays(
        pose=scene.obs_pose[:, :, :T], half_ext=scene.obs_half,
        valid=scene.obs_valid[:, :, :T], radius=scene.obs_radius)
    corridor = collision_ops.CorridorArrays(d_lo=scene.corridor_lo,
                                            d_hi=scene.corridor_hi)
    static = dict(dt=dt, n_steps=n_steps,
                  cost_structure=("default", True, stopping),
                  constraint_flags=(True,) * 5)
    return (cl, ca, tl, gv, scene.ref, scene.veh, obstacles, corridor,
            carry.orientation, cost_params, low_vel, ref_s_last), static


@pytest.mark.parametrize("n_steps", [20, 60], ids=["T21", "T61"])
def test_triton_rows_match_xla_scorer(repo_root, n_steps):
    args, static = _fleet_args(repo_root, n_steps, 1)
    with jax.enable_x64(False):
        want = [np.asarray(r) for r in cycle_ops.score_fleet(*args, **static)]
        got = [np.asarray(r) for r in triton_scorer.score_fleet_triton(
            *args, **static, interpret=True)]
    assert got[2].dtype == np.int32
    for name, w, g in zip(("masked", "kin", "reasons"), want, got):
        assert g.shape == w.shape, name
    np.testing.assert_array_equal(got[2], want[2])
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        assert fin.any()
        # float32 sums in another order than XLA's reductions
        np.testing.assert_allclose(g[fin], w[fin], rtol=2e-5)


def test_triton_stopping_rows_against_float64(repo_root):
    """Stopping quintics end at rest, where s_dot is 0 up to float32
    rounding and the -EPS velocity check decides on noise: there both
    float32 programs may disagree with float64.  The kernel must disagree
    with the float64 scorer on no more candidates than the XLA float32
    scorer does, and agree on the costs where both are finite."""
    args, static = _fleet_args(repo_root, 20, 2, stopping=True)
    as64 = lambda tree: jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
    ref = [np.asarray(r) for r in cycle_ops.score_fleet(*as64(args),
                                                       **static)]
    with jax.enable_x64(False):
        xla = [np.asarray(r) for r in cycle_ops.score_fleet(*args, **static)]
        got = [np.asarray(r) for r in triton_scorer.score_fleet_triton(
            *args, **static, interpret=True)]
    for f in range(ref[2].shape[0]):
        off_kernel = got[2][f] != ref[2][f]
        off_xla = xla[2][f] != ref[2][f]
        assert off_kernel.sum() <= off_xla.sum(), f
    both = np.isfinite(got[1]) & np.isfinite(xla[1])
    assert both.any()
    np.testing.assert_allclose(got[1][both], xla[1][both], rtol=2e-5)


def test_triton_pads_candidate_axis_and_checks_scope(repo_root):
    """K not a multiple of the block: padded candidates are sliced away;
    a polygon group is refused instead of silently ignored."""
    args, static = _fleet_args(repo_root, 20, 1)
    cut = tuple(a[:, :77] if i < 4 else a for i, a in enumerate(args))
    with jax.enable_x64(False):
        full = triton_scorer.score_fleet_triton(*args, **static,
                                                interpret=True)
        part = triton_scorer.score_fleet_triton(*cut, **static,
                                                interpret=True)
    for f_row, p_row in zip(full, part):
        assert p_row.shape == (4, 77)
        np.testing.assert_array_equal(np.asarray(p_row),
                                      np.asarray(f_row)[:, :77])
    obstacles = args[6]
    F, M, T = obstacles.valid.shape
    with_poly = obstacles._replace(
        poly_verts=jnp.zeros((F, 1, T, 3, 2)),
        poly_valid=jnp.zeros((F, 1, T), dtype=bool))
    assert not triton_scorer.supports(with_poly)
    with pytest.raises(ValueError, match="polygon"):
        triton_scorer.score_fleet_triton(
            *args[:6], with_poly, *args[7:], **static, interpret=True)


def test_triton_single_problem_form(repo_root):
    """``score_candidates_triton`` (a fleet of one) equals the XLA
    single-problem scorer on an unpadded table (``ref_s_last`` None)."""
    args, static = _fleet_args(repo_root, 20, 1)
    f = 1                                           # DEU_Test: 2 obstacles
    member = lambda tree: jax.tree.map(lambda a: a[f], tree)
    one = member(args[:11])
    with jax.enable_x64(False):
        want = cycle_ops.score_candidates(*one, **static)
        got = triton_scorer.score_candidates_triton(*one, **static,
                                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    for w, g in zip(want[:2], got[:2]):
        w, g = np.asarray(w), np.asarray(g)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        assert fin.any()
        np.testing.assert_allclose(g[fin], w[fin], rtol=2e-5)
