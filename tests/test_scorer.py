"""The fused scorer (ops.cycle.score_candidates / score_fleet).

Its three [K] rows must agree with the dense conformance program
(``cycle.evaluate_level``) run in float32 on the same bundle, on every
bundled scenario; and the fleet form on a sentinel-padded mixed fleet must
reproduce the single-problem form member by member.
"""

import logging

import numpy as np
import pytest

import jax.numpy as jnp

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cycle as cycle_ops
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.parallel import fleet as fleet_ops
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

SCENARIOS = ["DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1", "ZAM_Over-1_1",
             "ZAM_Tjunction-1_42_T-1"]


def _planner(repo_root, name):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / f"{name}.yaml", f"{name}.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario(f"{name}.xml")
    config.update()
    config.debug.kernel_dtype = "float32"
    config.debug.fast_scoring = False
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    return planner


@pytest.mark.parametrize("name", SCENARIOS)
def test_scorer_rows_match_evaluate_level(repo_root, name):
    planner = _planner(repo_root, name)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    planner._low_vel_mode = \
        planner.x_0.velocity < planner.config.planning.low_vel_mode_threshold
    x0_lon, x0_lat = planner.x_0_cl
    batch = planner._create_trajectory_bundle(x0_lon, x0_lat, 1)
    goal_valid = jnp.asarray(planner._goal_valid_mask(batch))
    ctx = planner._scene_context()
    dtype = jnp.float32
    cl = jnp.asarray(batch.coeffs_lon, dtype)
    ca = jnp.asarray(batch.coeffs_lat, dtype)
    tl = jnp.asarray(batch.traj_len)
    theta0 = jnp.asarray(planner.x_0.orientation, dtype)
    structure = planner.cost_function.structure

    want = cycle_ops.evaluate_level(
        cl, ca, tl, goal_valid, planner._co.tables, ctx["veh"],
        ctx["obstacles"], None, ctx["corridor"], theta0, ctx["cost_params"],
        dt=planner.dt, n_steps=planner.N,
        low_vel_mode=planner._low_vel_mode, cost_structure=structure,
        constraint_flags=ctx["flags"], boundary_mode=ctx["boundary_mode"])
    masked, kin, reasons = cycle_ops.score_candidates(
        cl, ca, tl, goal_valid, planner._co.tables, ctx["veh"],
        ctx["obstacles"], planner._corridor_or_unbounded(ctx["corridor"]),
        theta0, ctx["cost_params"], jnp.asarray(planner._low_vel_mode),
        dt=planner.dt, n_steps=planner.N, cost_structure=structure,
        constraint_flags=ctx["flags"])
    masked, kin, reasons = (np.asarray(a) for a in (masked, kin, reasons))

    feasible, collides, want_reasons = np.asarray(want.masks).astype(int)
    feasible, collides = feasible.astype(bool), collides.astype(bool)
    costs = np.asarray(want.costs)
    assert masked.shape == kin.shape == reasons.shape == (batch.size,)
    assert reasons.dtype == np.int32
    np.testing.assert_array_equal(reasons, want_reasons)
    np.testing.assert_array_equal(np.isfinite(kin), feasible)
    ok = feasible & ~collides & np.isfinite(costs)
    np.testing.assert_array_equal(np.isfinite(masked), ok)
    assert ok.any(), "degenerate bundle: nothing selectable"
    np.testing.assert_allclose(masked[ok], costs[ok], rtol=1e-6)
    assert int(np.argmin(masked)) == int(np.asarray(want.scalars)[0])


def test_fleet_form_matches_single_on_padded_mixed_fleet(repo_root):
    """Three scenarios with different reference-path lengths and obstacle
    counts, one member in low-velocity mode: the fleet scene pads refs with
    arclength sentinels, corridors with unbounded bands and obstacles with
    invalid rows; the fleet rows must equal each member's rows on its own
    unpadded tables."""
    n_steps, dt = 20, 0.1
    dtype = jnp.float32
    problems = []
    for name in ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1"):
        scenario, pp, _ = load_scenario_and_planning_problem(
            str(repo_root / "example_scenarios" / f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        problems.append(fleet_ops.problem_from_planner_setup(
            scenario, pp, route.reference_path, n_steps=n_steps,
            horizon_pad=10, dtype=dtype))
    assert problems[0]["ref_tables"].s.shape != \
        problems[1]["ref_tables"].s.shape
    assert problems[2]["velocity"] < 4.0        # a low-velocity member
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps, dtype=dtype)
    F, T = len(problems), n_steps + 1
    grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt, -3.0, 3.0, 4)

    low_vel = carry.velocity < 4.0
    v_min = jnp.maximum(0.0, carry.velocity - 1.0)
    cands = [grid_ops.velocity_keeping_candidates(
        carry.x0_lon[f], carry.x0_lat[f], v_min[f], v_min[f] + 5.0,
        low_vel[f], grid) for f in range(F)]
    cl, ca, tl = (jnp.stack([c[i] for c in cands]) for i in range(3))
    K = cl.shape[1]
    gv = jnp.ones((F, K), dtype=bool)
    s = scene.ref.s
    ref_s_last = jnp.max(jnp.where(s < s[:, :1] + 5e5, s, -jnp.inf), axis=1)
    cost_params = cycle_ops.CostParams(
        w_a=jnp.full(F, 5.0, dtype), desired_d=jnp.zeros(F, dtype),
        desired_speed=scene.desired_speed, desired_s=jnp.zeros(F, dtype))
    obstacles = collision_ops.ObstacleArrays(
        pose=scene.obs_pose[:, :, :T], half_ext=scene.obs_half,
        valid=scene.obs_valid[:, :, :T], radius=scene.obs_radius)
    corridor = collision_ops.CorridorArrays(d_lo=scene.corridor_lo,
                                            d_hi=scene.corridor_hi)
    static = dict(dt=dt, n_steps=n_steps, cost_structure=("default", True,
                                                          False),
                  constraint_flags=(True,) * 5)
    got = cycle_ops.score_fleet(cl, ca, tl, gv, scene.ref, scene.veh,
                                obstacles, corridor, carry.orientation,
                                cost_params, low_vel, ref_s_last, **static)
    assert all(np.asarray(row).shape == (F, K) for row in got)

    for f, p in enumerate(problems):
        obs = p["obstacles"]
        single_obs = collision_ops.ObstacleArrays(
            pose=obs.pose[:, :T], half_ext=obs.half_ext, valid=obs.valid[:, :T],
            radius=obs.radius)
        member = lambda tree: type(tree)(*[leaf[f] for leaf in tree])
        want = cycle_ops.score_candidates(
            cl[f], ca[f], tl[f], gv[f], cycle_ops.as_float32(p["ref_tables"]),
            member(scene.veh), cycle_ops.as_float32(single_obs),
            cycle_ops.as_float32(p["corridor"]), carry.orientation[f],
            member(cost_params), low_vel[f], **static)
        masked, kin, reasons = (np.asarray(row[f]) for row in got)
        w_masked, w_kin, w_reasons = (np.asarray(row) for row in want)
        np.testing.assert_array_equal(reasons, w_reasons, err_msg=str(f))
        np.testing.assert_array_equal(np.isfinite(masked),
                                      np.isfinite(w_masked), err_msg=str(f))
        np.testing.assert_array_equal(np.isfinite(kin), np.isfinite(w_kin))
        fin = np.isfinite(w_masked)
        assert fin.any(), f"member {f}: nothing selectable"
        np.testing.assert_allclose(masked[fin], w_masked[fin], rtol=1e-6)


def test_plan_scores_through_the_backend_choice(repo_root, monkeypatch):
    """``plan()``'s fused escalation takes its scorer from ``backend.scorer``,
    the one selection point it shares with the scans: with the Triton
    kernel chosen (interpret mode here) it plans the XLA scorer's
    trajectory."""
    import functools

    from commonroad_rp_jax import backend
    from commonroad_rp_jax.ops import triton_scorer

    def plan_once():
        planner = _planner(repo_root, "ZAM_Over-1_1")
        planner.config.debug.fast_scoring = True
        cycle_ops._evaluate_levels_fast.clear_cache()
        return planner.plan()[0]

    want = plan_once()
    chosen = []

    def kernel(obstacles, platform=None):
        chosen.append(obstacles)
        return functools.partial(triton_scorer.score_candidates_triton,
                                 interpret=True)

    monkeypatch.setattr(backend, "scorer", kernel)
    got = plan_once()
    assert chosen, "plan() did not ask backend.scorer for its scorer"
    np.testing.assert_allclose(
        np.asarray([s.position for s in got.state_list]),
        np.asarray([s.position for s in want.state_list]), atol=1e-4)
