#!/usr/bin/env python3
"""Smoke test of the planner on an NVIDIA GPU: the main paths once, at full
width, each checked against the repository's own references.

    python chip_smoke.py               # phases (a)-(d) on one card
    python chip_smoke.py --four-cards  # only: a fleet sharded over 4 cards
                                       #   against the same fleet on one card
    python chip_smoke.py --rehearse    # every phase on the CPU at reduced
                                       #   sizes; never prints the ok line

Phases (one process, one card):
  (a) ZAM_Over-1_1 through run_planner's host loop with ``plan()`` under the
      backend-resolved defaults: the fused scorer (on the GPU the Triton
      kernel) runs every cycle, the goal is reached and every driven
      transition is KS-feasible.
  (b) the same scenario through ``plan_scan``: the same step count and the
      same positions as (a); then all four bundled scenarios reach their
      goals through ``plan_scan``.
  (c) full width: ZAM_Over at sampling level 3 with the bundled 2 s horizon
      (K=2754, T=21) and the reference's default 6 s horizon (N=60,
      K=8874, T=61), the fused scorer in float32 against
      ``cycle.evaluate_level`` in float64.
  (d) a 128-problem fleet, 10 cycles at level 3, through the fleet scan
      against ``parallel.fleet.make_fleet_rollout``.

Each phase prints its compile seconds, ``compiled.memory_analysis()``, the
device's ``peak_bytes_in_use`` and a warm time labelled with the card.  Any
failed check raises, so the process exits non-zero; it exits non-zero
without a result as well when JAX finds no GPU.  The last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, each with its reason
POS_TOL_M = 1e-3        # (a) vs (b): one float32 program, host vs device carry
COST_RTOL = 1e-4        # float32 vs float64 cost sums over <= 61 steps
FLEET_COST_RTOL = 1e-3  # winners re-rolled vs dense rows, 10 float32 cycles
BOUND_EPS = 1e-4        # relative slack on the vehicle limits (phase c)
BOUND_DELTA_M = 1e-3    # slack on the vehicle half extents (phase c)


def _say(*parts):
    print(*parts, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "unavailable"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    return ", ".join(f"{f}={getattr(m, f, None)}" for f in fields)


def _report(ctx, phase, compiled, compile_s, warm_s, what):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    _say(f"[{phase}] compile_s={compile_s:.3f}")
    _say(f"[{phase}] memory_analysis: {_memory(compiled)}")
    _say(f"[{phase}] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    _say(f"[{phase}] warm {what} = {warm_s:.6f} s on {ctx['card']}")


def _timed(fn, *args, repeats=3):
    """Median wall seconds of ``fn(*args)`` with the result on device."""
    import jax
    import numpy as np

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _compile(jitted, *args, **kwargs):
    """(compiled, seconds) of an explicit ahead-of-time lower + compile."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    return compiled, time.perf_counter() - t0


def _config(ctx, scenario):
    import run_planner

    config = run_planner.load_config(scenario)
    if ctx["rehearse"]:
        # the CPU resolves to the float64 conformance path; rehearse the
        # GPU defaults
        config.debug.kernel_dtype = "float32"
        config.debug.fast_scoring = True
    return config


# ---------------------------------------------------------------------------
# (a) host loop with plan()
# ---------------------------------------------------------------------------

def phase_a(ctx):
    import jax
    import numpy as np

    import run_planner
    from commonroad_rp_jax import backend
    from commonroad_rp_jax.ops import cycle as cycle_ops
    from commonroad_rp_jax.ops import triton_scorer
    from commonroad_rp_jax.utils.evaluation import run_evaluation

    _say("== (a) ZAM_Over-1_1: run_planner host loop, plan() ==")
    calls = []
    fused = cycle_ops._evaluate_levels_fast

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return fused(*args, **kwargs)

    config = _config(ctx, "ZAM_Over-1_1")
    planner = run_planner.build_planner(config)
    assert config.debug.fast_scoring is True, config.debug.fast_scoring
    assert config.debug.kernel_dtype == "float32", config.debug.kernel_dtype
    planner.record_state_and_input(planner.x_0)
    cycle_ops._evaluate_levels_fast = spy
    try:
        run_planner.drive_host_loop(planner, config, max_steps=300)
    finally:
        cycle_ops._evaluate_levels_fast = fused
    assert planner.goal_reached(), "host loop did not reach the goal"
    n_plans = len(planner.planning_times)
    assert len(calls) == n_plans, \
        f"fused scorer ran {len(calls)} times for {n_plans} plan() calls"
    _, feasible = run_evaluation(planner.config, planner.record_state_list,
                                 planner.record_input_list)
    assert len(feasible) and all(feasible), \
        f"KS-infeasible transitions: {len(feasible) - sum(feasible)}"
    steps = len(planner.record_state_list) - 1
    score = backend.scorer(planner._scene_context()["obstacles"])
    if not ctx["rehearse"]:
        assert score is triton_scorer.score_candidates_triton, score
    _say(f"[a] fused scorer chosen (kernel_dtype=float32, fast_scoring=True;"
         f" plan() scores with {score.__module__}.{score.__name__});"
         f" goal reached in {steps} steps, {n_plans} plan() calls; "
         f"{len(feasible)}/{len(feasible)} transitions KS-feasible")

    args, kwargs = calls[0]
    with jax.enable_x64(False):
        compiled, _ = _compile(fused, *args, **kwargs)
    first, warm = planner.planning_times[0], \
        float(np.median(planner.planning_times[1:]))
    _report(ctx, "a", compiled, first - warm, warm,
            "plan() p50 per cycle (first call minus warm = compile_s)")
    return dict(steps=steps, positions=np.asarray(
        [s.position for s in planner.record_state_list]))


# ---------------------------------------------------------------------------
# (b) plan_scan
# ---------------------------------------------------------------------------

def phase_b(ctx, host):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import run_planner
    from commonroad_rp_jax.parallel import pallas_fleet

    _say("== (b) plan_scan: ZAM_Over-1_1 against (a), then all scenarios ==")
    built = []
    make = pallas_fleet.make_facade_replanning_scan

    def spy(*args, **kwargs):
        run = make(*args, **kwargs)

        def recorded(carry, desired_speed_val=None):
            built.append((run, carry, desired_speed_val))
            return run(carry, desired_speed_val)
        return recorded

    pallas_fleet.make_facade_replanning_scan = spy
    try:
        config = _config(ctx, "ZAM_Over-1_1")
        planner = run_planner.build_planner(config)
        planner.record_state_and_input(planner.x_0)
        infos = run_planner.drive_scan_loop(planner, config, max_steps=300)
    finally:
        pallas_fleet.make_facade_replanning_scan = make
    assert planner.goal_reached(), "plan_scan did not reach the goal"
    steps = len(planner.record_state_list) - 1
    assert steps == host["steps"], (steps, host["steps"])
    pos = np.asarray([s.position for s in planner.record_state_list])
    dev = float(np.max(np.abs(pos - host["positions"])))
    _say(f"[b] {steps} steps (host loop {host['steps']}); max position "
         f"difference to (a) {dev:.3e} m (tolerance {POS_TOL_M} m: one "
         f"float32 scorer, carried on the host vs on the device)")
    assert dev <= POS_TOL_M, dev

    run, carry, ds = built[0]
    with jax.enable_x64(False):
        ds = jnp.asarray(ds, jnp.float32)
        compiled, _ = _compile(run.jitted, carry, ds)
        warm = _timed(compiled, carry, ds)
    chunk = 12                       # drive_scan_loop's cycles per dispatch
    _report(ctx, "b", compiled, infos[0]["wall_time"] - warm, warm / chunk,
            f"plan_scan device program per cycle ({chunk}-cycle dispatch; "
            f"first dispatch minus warm = compile_s)")

    for name in ("ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM-Ramp-1_1-T-1",
                 "ZAM_Tjunction-1_42_T-1"):
        config = _config(ctx, name)
        planner = run_planner.build_planner(config)
        planner.record_state_and_input(planner.x_0)
        infos = run_planner.drive_scan_loop(planner, config, max_steps=300)
        assert planner.goal_reached(), f"{name}: goal not reached"
        cycles = sum(i["cycles_run"] for i in infos)
        wall = sum(i["wall_time"] for i in infos)
        _say(f"[b] {name}: goal reached in "
             f"{len(planner.record_state_list) - 1} steps, {cycles} cycles, "
             f"{wall / max(cycles, 1) * 1e3:.3f} ms per cycle incl. first "
             f"dispatch, on {ctx['card']}")


# ---------------------------------------------------------------------------
# (c) full-width scorer against the float64 conformance program
# ---------------------------------------------------------------------------

def _level_setup(ctx, n_steps, dtype_name, level):
    import jax.numpy as jnp

    import run_planner

    config = _config(ctx, "ZAM_Over-1_1")
    config.planning.time_steps_computation = n_steps
    config.planning.planning_horizon = config.planning.dt * n_steps
    config.debug.kernel_dtype = dtype_name
    config.debug.fast_scoring = False
    planner = run_planner.build_planner(config)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.x_0_cl = planner._compute_initial_states(planner.x_0)
    planner._low_vel_mode = \
        planner.x_0.velocity < config.planning.low_vel_mode_threshold
    batch = planner._create_trajectory_bundle(*planner.x_0_cl, level)
    scene = planner._scene_context()
    dtype = jnp.float32 if dtype_name == "float32" else jnp.float64
    return dict(
        planner=planner, scene=scene, K=batch.size,
        cl=jnp.asarray(batch.coeffs_lon, dtype),
        ca=jnp.asarray(batch.coeffs_lat, dtype),
        tl=jnp.asarray(batch.traj_len),
        gv=jnp.asarray(planner._goal_valid_mask(batch)),
        theta0=jnp.asarray(planner.x_0.orientation, dtype))


def _f64_masks(s64, veh):
    import numpy as np

    from commonroad_rp_jax.ops import cycle as cycle_ops

    p, sc = s64["planner"], s64["scene"]
    out = cycle_ops.evaluate_level(
        s64["cl"], s64["ca"], s64["tl"], s64["gv"], p._co.tables, veh,
        sc["obstacles"], None, sc["corridor"], s64["theta0"],
        sc["cost_params"], dt=p.dt, n_steps=p.N, low_vel_mode=p._low_vel_mode,
        cost_structure=p.cost_function.structure, constraint_flags=sc["flags"],
        boundary_mode=sc["boundary_mode"])
    masks = np.asarray(out.masks)
    return out, masks[0].astype(bool), masks[1].astype(bool)


def phase_c(ctx):
    import jax
    import numpy as np

    from commonroad_rp_jax.backend import scorer

    _say("== (c) full width: fused scorer (float32) vs evaluate_level "
         "(float64), ZAM_Over-1_1 level 3 ==")
    for n_steps in ctx["horizons"]:
        s32 = _level_setup(ctx, n_steps, "float32", ctx["level"])
        s64 = _level_setup(ctx, n_steps, "float64", ctx["level"])
        p, sc = s32["planner"], s32["scene"]
        args = (s32["cl"], s32["ca"], s32["tl"], s32["gv"], p._co.tables,
                sc["veh"], sc["obstacles"],
                p._corridor_or_unbounded(sc["corridor"]), s32["theta0"],
                sc["cost_params"], jax.numpy.asarray(p._low_vel_mode))
        static = dict(dt=p.dt, n_steps=p.N,
                      cost_structure=p.cost_function.structure,
                      constraint_flags=sc["flags"])
        score = scorer(sc["obstacles"])
        _say(f"[c] scorer on this platform: {score.__module__}."
             f"{score.__name__}")
        with jax.enable_x64(False):
            lowered = jax.jit(functools.partial(score, **static)).lower(*args)
            n_dot = lowered.as_text().count("dot_general")
            t0 = time.perf_counter()
            compiled = lowered.compile()
            compile_s = time.perf_counter() - t0
            masked, kin, reasons = (np.asarray(a) for a in compiled(*args))
            warm = _timed(compiled, *args)
        T = n_steps + 1
        K = s32["K"]
        _say(f"[c] N={n_steps}: K={K} candidates, T={T} steps; precision: "
             f"{n_dot} dot_general ops in the scorer program, so no matrix "
             f"product and no TF32 rounding — float32 elementwise throughout")
        assert n_dot == 0, n_dot

        veh = s64["scene"]["veh"]
        ref, feas64, coll64 = _f64_masks(s64, veh)
        scale = lambda f, h: veh._replace(
            a_max=veh.a_max * f, kappa_max=veh.kappa_max * f,
            v_delta_max=veh.v_delta_max * f,
            half_length=veh.half_length + h, half_width=veh.half_width + h)
        _, feas_lo, coll_lo = _f64_masks(
            s64, scale(1 + BOUND_EPS, -BOUND_DELTA_M))
        _, feas_hi, coll_hi = _f64_masks(
            s64, scale(1 - BOUND_EPS, BOUND_DELTA_M))
        near = (feas_lo != feas_hi) | (coll_lo != coll_hi)
        feas32 = np.isfinite(kin)
        ok64 = feas64 & ~coll64 & np.isfinite(np.asarray(ref.costs))
        ok32 = np.isfinite(masked)
        diff = (feas32 != feas64) | (ok32 != ok64)
        _say(f"[c] N={n_steps}: {int(diff.sum())} of {K} candidates differ "
             f"in the feasible/selectable masks; {int(near.sum())} lie within "
             f"{BOUND_EPS:g} (relative, vehicle limits) or {BOUND_DELTA_M} m "
             f"(half extents) of a constraint bound in float64; unexplained "
             f"differences: {int((diff & ~near).sum())}")
        assert not (diff & ~near).any(), np.flatnonzero(diff & ~near)[:20]
        best32 = int(np.argmin(masked))
        best64 = int(np.asarray(ref.scalars)[0])
        _say(f"[c] N={n_steps}: selected index float32 {best32}, "
             f"float64 {best64}")
        assert best32 == best64, (best32, best64)
        both = ok32 & ok64
        costs64 = np.asarray(ref.costs)
        rel = float(np.max(np.abs(masked[both] - costs64[both])
                           / np.abs(costs64[both])))
        _say(f"[c] N={n_steps}: {int(both.sum())} finite costs agree to "
             f"max relative error {rel:.3e} (tolerance {COST_RTOL:g}: "
             f"float32 sums of <= {T} squared terms vs float64)")
        assert rel <= COST_RTOL, rel
        _report(ctx, f"c N={n_steps}", compiled, compile_s, warm,
                f"scorer call ({K / warm:.1f} candidates/s)")


# ---------------------------------------------------------------------------
# (d) fleet scan against the dense fleet rollout
# ---------------------------------------------------------------------------

def _fleet(n_problems, n_steps, horizon_pad):
    """A jittered fleet over two bundled scenarios and three vehicle types
    (host-side numpy assembly, one scene build)."""
    import jax.numpy as jnp
    import numpy as np

    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import \
        load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    base = []
    for name in ("ZAM_Over-1_1", "DEU_Test-1_1_T-1"):
        scenario, pp, _ = load_scenario_and_planning_problem(
            os.path.join(ROOT, "example_scenarios", f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        for vid in (1, 2, 3):
            base.append(fleet_ops.problem_from_planner_setup(
                scenario, pp, route.reference_path, n_steps=n_steps,
                horizon_pad=horizon_pad, dtype=jnp.float32,
                vehicle=VehicleConfiguration(id_type_vehicle=vid)))
    rng = np.random.default_rng(0)
    problems = []
    for i in range(n_problems):
        p = dict(base[i % len(base)])
        v_scale = float(rng.uniform(0.92, 1.08))
        p["velocity"] = float(p["velocity"]) * v_scale
        p["x0_lon"] = np.asarray(p["x0_lon"], np.float64) * [1.0, v_scale, 1.0]
        x0_lat = np.asarray(p["x0_lat"], np.float64).copy()
        x0_lat[0] += float(rng.uniform(-0.25, 0.25))
        p["x0_lat"] = x0_lat
        problems.append(p)
    return fleet_ops.build_fleet_scene(problems, n_steps, dtype=jnp.float32)


def _fleet_scan(scene, grid, n_steps, n_cycles, mesh=None):
    from commonroad_rp_jax.parallel import pallas_fleet

    return pallas_fleet.make_pallas_fleet_scan(
        scene, grid, 0.1, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=n_steps * 0.1, n_cycles=n_cycles, mesh=mesh)


def phase_d(ctx):
    import jax
    import numpy as np

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh

    F, C, n_steps = ctx["fleet"], ctx["cycles"], 20
    _say(f"== (d) fleet: {F} problems x {C} cycles at level {ctx['level']}, "
         f"fleet scan vs make_fleet_rollout ==")
    scene, carry = _fleet(F, n_steps, horizon_pad=3 * C + 10)
    grid = grid_ops.make_static_grid(ctx["level"], 0.4, n_steps * 0.1, 0.1,
                                     -3.0, 3.0, 4)
    K = grid.size
    run = _fleet_scan(scene, grid, n_steps, C)
    run_x = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(1), None, grid, 0.1, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=n_steps * 0.1, n_cycles=C)
    with jax.enable_x64(False):
        compiled, compile_s = _compile(run.jitted, carry)
        final, metrics = compiled(carry)
        warm = _timed(compiled, carry)
    compiled_x, compile_x = _compile(run_x, carry, scene)
    final_x, metrics_x = compiled_x(carry, scene)
    warm_x = _timed(compiled_x, carry, scene)

    found = np.asarray(metrics[0])
    found_x = np.asarray(metrics_x.found)
    cost, cost_x = np.asarray(metrics[1]), np.asarray(metrics_x.best_cost)
    np.testing.assert_array_equal(found, found_x)
    fin = np.isfinite(cost_x)
    np.testing.assert_allclose(cost[fin], cost_x[fin], rtol=FLEET_COST_RTOL)
    rel = float(np.max(np.abs(cost[fin] - cost_x[fin]) / np.abs(cost_x[fin])))
    _say(f"[d] found flags equal on all {F} members x {C} cycles "
         f"({int(found.sum())} found); chosen costs agree to max relative "
         f"error {rel:.3e} (tolerance {FLEET_COST_RTOL:g}: winners re-rolled "
         f"alone vs dense rows, float32 over {C} cycles)")
    _report(ctx, "d fleet scan", compiled, compile_s, warm,
            f"{C}-cycle fleet scan ({F * K * C / warm:.1f} candidate-evals/s)")
    _report(ctx, "d make_fleet_rollout", compiled_x, compile_x, warm_x,
            f"{C}-cycle dense fleet rollout "
            f"({F * K * C / warm_x:.1f} candidate-evals/s)")


# ---------------------------------------------------------------------------
# --four-cards: a fleet sharded over 4 cards against one card
# ---------------------------------------------------------------------------

def phase_four(ctx):
    import jax
    import numpy as np

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh

    n_dev = len(jax.devices())
    assert n_dev >= 4, f"--four-cards needs 4 devices, JAX sees {n_dev}"
    F, C, n_steps = ctx["fleet4"], ctx["cycles"], 20
    _say(f"== four cards: {F} problems x {C} cycles at level {ctx['level']}, "
         f"sharded over 4 devices vs one device ==")
    scene, carry = _fleet(F, n_steps, horizon_pad=3 * C + 10)
    grid = grid_ops.make_static_grid(ctx["level"], 0.4, n_steps * 0.1, 0.1,
                                     -3.0, 3.0, 4)
    K = grid.size
    one = _fleet_scan(scene, grid, n_steps, C)
    four = _fleet_scan(scene, grid, n_steps, C, mesh=make_fleet_mesh(4))
    with jax.enable_x64(False):
        c1, s1 = _compile(one.jitted, carry)
        c4, s4 = _compile(four.jitted, carry)
        final1, m1 = c1(carry)
        final4, m4 = c4(carry)
        w1 = _timed(c1, carry)
        w4 = _timed(c4, carry)
    found1, found4 = np.asarray(m1[0]), np.asarray(m4[0])
    np.testing.assert_array_equal(found4, found1)
    np.testing.assert_array_equal(np.asarray(m4[4]), np.asarray(m1[4]))
    cost1, cost4 = np.asarray(m1[1]), np.asarray(m4[1])
    same = int(np.sum((cost1 == cost4) | (np.isinf(cost1) & np.isinf(cost4))))
    np.testing.assert_allclose(cost4, cost1, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(final4.x0_lon),
                               np.asarray(final1.x0_lon), rtol=1e-6,
                               atol=1e-5)
    mean1, mean4 = np.asarray(m1[5]), np.asarray(m4[5])
    np.testing.assert_allclose(mean4, mean1, rtol=1e-6)
    _say(f"[4] found flags and the psum'd success counts identical "
         f"({int(found1.sum())} found); winners' costs bitwise equal on "
         f"{same}/{cost1.size}, all within rtol 1e-6; psum'd mean cost max "
         f"relative difference "
         f"{float(np.max(np.abs(mean4 - mean1) / np.abs(mean1))):.3e} "
         f"(float32 sum regrouped by shard)")
    _report(ctx, "4 one device", c1, s1, w1,
            f"{C}-cycle fleet scan ({F * K * C / w1:.1f} candidate-evals/s)")
    _report(ctx, "4 four devices", c4, s4, w4,
            f"{C}-cycle fleet scan ({F * K * C / w4:.1f} candidate-evals/s)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded fleet check")
    parser.add_argument("--rehearse", action="store_true",
                        help="run the phases on the CPU at reduced sizes "
                             "(no result line; exits 3)")
    args = parser.parse_args()

    import jax

    platform = jax.default_backend()
    if platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: JAX found no GPU (default backend "
              f"{platform!r})", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from commonroad_rp_jax import native
    from commonroad_rp_jax.backend import enable_compile_cache

    cache = enable_compile_cache()
    card = "cpu (rehearsal)" if args.rehearse else _card_line()
    _say(card)
    _say(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
         f"{jax.devices()[0].device_kind}; compile cache: {cache}")
    built = native.available() and native.built_here
    _say(f"native host library: {'built from source in this run' if built else 'found prebuilt' if native.available() else 'unavailable'}")

    ctx = dict(card=card, rehearse=args.rehearse)
    if args.rehearse:
        ctx.update(horizons=(20, 60), level=1, fleet=8, fleet4=8, cycles=3)
    else:
        ctx.update(horizons=(20, 60), level=3, fleet=128, fleet4=512,
                   cycles=10)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four(ctx)
    else:
        host = phase_a(ctx)
        phase_b(ctx, host)
        phase_c(ctx)
        phase_d(ctx)
    _say(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    if args.rehearse:
        return 3
    devices = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
