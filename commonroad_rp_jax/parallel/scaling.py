"""Scaling-efficiency benchmark over the device mesh.

Measures fleet planning throughput (candidate evaluations / second) at
increasing device counts with constant per-device load (weak scaling), and
reports efficiency = throughput(n) / (n * throughput(1)) — the
SURVEY.md section 6 north-star metric (>= 80% multi-host scaling efficiency).

Run standalone on the virtual CPU mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m commonroad_rp_jax.parallel.scaling --platform cpu
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np


def measure_scaling(device_counts: Optional[List[int]] = None,
                    problems_per_device: int = 4,
                    n_cycles: int = 5,
                    n_steps: int = 10,
                    level: int = 1,
                    repeats: int = 5,
                    dtype=None) -> Dict:
    """Weak-scaling sweep of the fleet replanning scan."""
    import jax
    import jax.numpy as jnp

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner
    import os

    dtype = dtype or jnp.float32
    total_devices = len(jax.devices())
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32)
                         if n <= total_devices]

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    scenario, pp, _ = load_scenario_and_planning_problem(
        os.path.join(root, "example_scenarios", "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    problem = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=60,
        dtype=dtype)

    veh_cfg = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(
        wheelbase=jnp.asarray(veh_cfg.wheelbase, dtype),
        wb_rear_axle=jnp.asarray(veh_cfg.wb_rear_axle, dtype),
        a_max=jnp.asarray(veh_cfg.a_max, dtype),
        v_switch=jnp.asarray(veh_cfg.v_switch, dtype),
        kappa_max=jnp.asarray(np.tan(veh_cfg.delta_max) / veh_cfg.wheelbase,
                              dtype),
        v_delta_max=jnp.asarray(veh_cfg.v_delta_max, dtype),
        half_length=jnp.asarray(0.5 * veh_cfg.length, dtype),
        half_width=jnp.asarray(0.5 * veh_cfg.width, dtype))
    dt = 0.1
    static_grid = grid_ops.make_static_grid(level, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    K = static_grid.size

    results = []
    for n_dev in device_counts:
        F = n_dev * problems_per_device
        scene, carry = fleet_ops.build_fleet_scene([problem] * F, n_steps,
                                                   dtype=dtype)
        mesh = make_fleet_mesh(n_dev)
        run = fleet_ops.make_fleet_rollout(
            mesh, veh, static_grid, dt, n_steps, replan_offset=3,
            low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=n_cycles)
        out = run(carry, scene)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(repeats):
            out = run(carry, scene)
        jax.block_until_ready(out)
        elapsed = (time.time() - t0) / repeats
        throughput = F * K * n_cycles / elapsed
        results.append(dict(devices=n_dev, problems=F,
                            throughput_evals_per_sec=round(throughput, 1),
                            time_s=round(elapsed, 5)))

    base = results[0]["throughput_evals_per_sec"] / results[0]["devices"]
    for row in results:
        row["efficiency"] = round(
            row["throughput_evals_per_sec"] / (row["devices"] * base), 3)
    return {"candidates_per_cycle": K, "cycles": n_cycles,
            "problems_per_device": problems_per_device, "sweep": results}


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None)
    parser.add_argument("--problems-per-device", type=int, default=4)
    args = parser.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    report = measure_scaling(problems_per_device=args.problems_per_device)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
