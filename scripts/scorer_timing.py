#!/usr/bin/env python3
"""Time the Triton-route scorer against the XLA scorer on one GPU, inside
the paths that use it: the fleet scan (128 problems x 10 cycles at sampling
level 3, at the bundled T=21 and the reference's T=61), ``plan_scan`` and
per-call ``plan()`` on ZAM_Over-1_1.

    python scripts/scorer_timing.py [--pairs 10] [--out FILE]
    JAX_PLATFORMS=cpu python scripts/scorer_timing.py --rehearse

Each scan is built and compiled once per scorer; ``plan()`` is compiled
once per block, since its jit cache holds one scorer at a time.  Timed
blocks alternate xla, kernel, kernel, xla, ... so drift in the card's clocks
falls on both.  A block's time is the median of its runs (``plan()``: the
median over the cycles of one drive to the goal, the first call excluded).
The fleet scans' found flags must agree between the scorers.  The last line
of standard output is a JSON summary with the card's name and power limit;
``--out`` writes it to a file as well.  ``--rehearse`` runs everything on
the CPU at reduced sizes, with the kernel in interpret mode.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCORERS = ("xla", "kernel")


@contextlib.contextmanager
def use_scorer(name, interpret):
    """Route ``backend.scorer`` and ``backend.fleet_scorer`` to one scorer
    while the programs that call them are traced."""
    from commonroad_rp_jax import backend
    from commonroad_rp_jax.ops import cycle, triton_scorer

    if name == "xla":
        fleet, single = cycle.score_fleet, cycle.score_candidates
    else:
        fleet = functools.partial(triton_scorer.score_fleet_triton,
                                  interpret=interpret)
        single = functools.partial(triton_scorer.score_candidates_triton,
                                   interpret=interpret)
    saved = backend.fleet_scorer, backend.scorer
    backend.fleet_scorer = lambda obstacles, platform=None: fleet
    backend.scorer = lambda obstacles, platform=None: single
    try:
        yield
    finally:
        backend.fleet_scorer, backend.scorer = saved


def _median_s(fn, repeats=3):
    import jax

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _alternate(label, block, pairs):
    """Run ``block(name)`` (seconds) in the order x, k, k, x, x, k, ...;
    returns the summary of one path."""
    times = {name: [] for name in SCORERS}
    for i in range(pairs):
        for name in SCORERS if i % 2 == 0 else SCORERS[::-1]:
            times[name].append(block(name))
            print(f"[{label}] {name}: {times[name][-1] * 1e3:.3f} ms",
                  flush=True)
    xla, kernel = np.asarray(times["xla"]), np.asarray(times["kernel"])
    summary = {
        "xla_ms": [round(t * 1e3, 3) for t in xla],
        "kernel_ms": [round(t * 1e3, 3) for t in kernel],
        "xla_median_ms": round(float(np.median(xla)) * 1e3, 3),
        "kernel_median_ms": round(float(np.median(kernel)) * 1e3, 3),
        "kernel_faster_pairs": f"{int(np.sum(kernel < xla))}/{pairs}"}
    print(f"[{label}] median xla {summary['xla_median_ms']} ms, kernel "
          f"{summary['kernel_median_ms']} ms; kernel faster in "
          f"{summary['kernel_faster_pairs']} pairs", flush=True)
    return summary


def time_fleet_scan(ctx, n_steps):
    import jax

    import chip_smoke
    from commonroad_rp_jax.ops import grid as grid_ops

    F, C = ctx["fleet"], ctx["cycles"]
    scene, carry = chip_smoke._fleet(F, n_steps, horizon_pad=3 * C + 10)
    grid = grid_ops.make_static_grid(ctx["level"], 0.4, n_steps * 0.1, 0.1,
                                     -3.0, 3.0, 4)
    compiled, found = {}, {}
    with jax.enable_x64(False):
        for name in SCORERS:
            with use_scorer(name, ctx["interpret"]):
                run = chip_smoke._fleet_scan(scene, grid, n_steps, C)
                compiled[name] = run.jitted.lower(carry).compile()
            found[name] = np.asarray(compiled[name](carry)[1][0])
        np.testing.assert_array_equal(found["kernel"], found["xla"])
        label = f"fleet scan {F} x {C} cycles, K={grid.size}, T={n_steps + 1}"
        return label, _alternate(
            label, lambda name: _median_s(lambda: compiled[name](carry)),
            ctx["pairs"])


def time_plan_scan(ctx):
    import chip_smoke
    import run_planner

    n = 12                           # run_planner's cycles per dispatch
    planners = {}
    for name in SCORERS:
        with use_scorer(name, ctx["interpret"]):
            planner = run_planner.build_planner(
                chip_smoke._config(ctx, "ZAM_Over-1_1"))
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            planner.plan_scan(n, record=False)          # build + compile
        planners[name] = planner
    label = f"plan_scan ZAM_Over-1_1, per cycle ({n}-cycle dispatch)"
    return label, _alternate(
        label, lambda name: _median_s(
            lambda: planners[name].plan_scan(n, record=False)) / n,
        ctx["pairs"])


def time_plan(ctx):
    import chip_smoke
    import run_planner
    from commonroad_rp_jax.ops import cycle as cycle_ops

    steps = {}

    def block(name):
        cycle_ops._evaluate_levels_fast.clear_cache()
        with use_scorer(name, ctx["interpret"]):
            config = chip_smoke._config(ctx, "ZAM_Over-1_1")
            planner = run_planner.build_planner(config)
            planner.record_state_and_input(planner.x_0)
            run_planner.drive_host_loop(planner, config, max_steps=300)
        assert planner.goal_reached(), name
        steps.setdefault(name, set()).add(len(planner.record_state_list))
        return float(np.median(planner.planning_times[1:]))

    label = "plan() ZAM_Over-1_1, p50 per call"
    summary = _alternate(label, block, ctx["pairs"])
    assert steps["xla"] == steps["kernel"] and len(steps["xla"]) == 1, steps
    return label, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pairs", type=int, default=10,
                        help="alternated (xla, kernel) pairs per path")
    parser.add_argument("--out", default=None,
                        help="also write the JSON summary to this file")
    parser.add_argument("--rehearse", action="store_true",
                        help="run on the CPU at reduced sizes")
    args = parser.parse_args()

    import jax

    import chip_smoke
    from commonroad_rp_jax.backend import enable_compile_cache

    if jax.default_backend() != "gpu" and not args.rehearse:
        print(f"scorer_timing: JAX found no GPU (default backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = "cpu (rehearsal)" if args.rehearse else chip_smoke._card_line()
    print(card, flush=True)
    ctx = dict(rehearse=args.rehearse, interpret=args.rehearse,
               pairs=args.pairs)
    if args.rehearse:
        ctx.update(fleet=4, cycles=2, level=1, horizons=(20,))
    else:
        ctx.update(fleet=128, cycles=10, level=3, horizons=(20, 60))

    paths = {}
    for n_steps in ctx["horizons"]:
        label, summary = time_fleet_scan(ctx, n_steps)
        paths[label] = summary
    for timer in (time_plan_scan, time_plan):
        label, summary = timer(ctx)
        paths[label] = summary
    result = {"card": card, "jax": jax.__version__,
              "device_kind": jax.devices()[0].device_kind, "paths": paths}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
