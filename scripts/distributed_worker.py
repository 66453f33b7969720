"""Multi-process fleet-planning worker (jax.distributed smoke test).

Launched N times (one process per simulated host) by tests/test_distributed.py
or manually:

    python scripts/distributed_worker.py --process-id 0 --num-processes 2 \
        --coordinator localhost:12345

Each process owns a shard of the fleet; the sharded cycle step runs SPMD over
the global mesh and the psum fleet aggregate must equal the GLOBAL fleet size
on every process (SURVEY.md section 2.3: multi-host runtime,
jax.distributed.initialize).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--coordinator", default="localhost:12421")
    parser.add_argument("--problems-per-process", type=int, default=2)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    n_devices = len(jax.devices())
    assert n_devices >= args.num_processes, \
        f"expected >= {args.num_processes} global devices, got {n_devices}"

    dtype = jnp.float32
    n_steps, dt = 10, 0.1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scenario, pp, _ = load_scenario_and_planning_problem(
        os.path.join(root, "example_scenarios", "ZAM_Over-1_1.xml"))
    route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
    problem = fleet_ops.problem_from_planner_setup(
        scenario, pp, route.reference_path, n_steps=n_steps, horizon_pad=30,
        dtype=dtype)

    F = n_devices * args.problems_per_process
    scene, carry = fleet_ops.build_fleet_scene([problem] * F, n_steps,
                                               dtype=dtype)

    mesh = make_fleet_mesh()               # all global devices
    shard = NamedSharding(mesh, PartitionSpec("fleet"))

    def to_global(leaf):
        """Distribute a replicated host array: each process fills its shard."""
        arr = np.asarray(leaf)
        return jax.make_array_from_callback(
            arr.shape, shard, lambda index: arr[index])

    scene = jax.tree.map(to_global, scene)
    carry = jax.tree.map(to_global, carry)

    veh_cfg = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[np.float32(x) for x in [
        veh_cfg.wheelbase, veh_cfg.wb_rear_axle, veh_cfg.a_max,
        veh_cfg.v_switch, np.tan(veh_cfg.delta_max) / veh_cfg.wheelbase,
        veh_cfg.v_delta_max, veh_cfg.length / 2, veh_cfg.width / 2]])
    static_grid = grid_ops.make_static_grid(1, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    step = fleet_ops.make_fleet_step(mesh, veh, static_grid, dt, n_steps,
                                     replan_offset=3, low_vel_threshold=4.0,
                                     horizon=n_steps * dt)
    new_carry, metrics = jax.jit(step)(carry, scene)
    jax.block_until_ready(new_carry)

    # fleet_success is a psum over the GLOBAL mesh: every process must see F
    success = int(np.asarray(metrics.fleet_success))
    print(f"process {args.process_id}: global fleet_success={success} "
          f"(expected {F}) devices={n_devices}", flush=True)
    assert success == F, f"psum mismatch: {success} != {F}"
    print(f"process {args.process_id}: DISTRIBUTED OK", flush=True)


if __name__ == "__main__":
    main()
