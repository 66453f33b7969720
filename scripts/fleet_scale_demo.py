"""Fleet-scale demo: 1000+ heterogeneous planning problems, one device program.

Builds a heterogeneous fleet from all four bundled scenarios (ZAM_Over,
DEU_Test, ZAM_Tjunction, ZAM-Ramp) x three vehicle types x per-problem
jitter (initial speed/lateral offset, desired speed), runs the full
replanning scan in a single jit call, and reports candidate-evals/sec plus
per-problem goal-reached counts per scenario — the production deployment
shape (SURVEY.md section 2.3: scenario-axis data parallelism;
BASELINE.json configs[4] "1000s of scenarios").

    python scripts/fleet_scale_demo.py --pallas --fleet-size 1024 \
        --cycles 150 --freq 1

``--freq 1`` replans every scenario step so the recorded per-cycle winner
states land on every time step and the host-side goal check is exact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCENARIOS = ["ZAM_Over-1_1", "DEU_Test-1_1_T-1", "ZAM_Tjunction-1_42_T-1",
             "ZAM-Ramp-1_1-T-1"]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None)
    parser.add_argument("--fleet-size", type=int, default=128)
    parser.add_argument("--cycles", type=int, default=20)
    parser.add_argument("--freq", type=int, default=3,
                        help="replanning frequency (steps per cycle)")
    parser.add_argument("--level", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--jitter", action="store_true",
                        help="per-problem heterogeneity: vehicle types, "
                             "initial-speed scale, lateral offset, "
                             "desired-speed scale")
    parser.add_argument("--goal-check", action="store_true",
                        help="evaluate per-problem goal-reached from the "
                             "recorded winner states (host side)")
    parser.add_argument("--pallas", action="store_true",
                        help="score with the fused scorer, re-rolling only "
                             "the winners "
                             "(parallel.pallas_fleet.make_pallas_fleet_scan)")
    args = parser.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from commonroad_rp_jax.backend import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from commonroad_rp_jax.ops import grid as grid_ops
    from commonroad_rp_jax.ops import kinematics as kin_ops
    from commonroad_rp_jax.parallel import fleet as fleet_ops
    from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
    from commonroad_rp_jax.utils.config import VehicleConfiguration
    from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem
    from commonroad_rp_jax.utils.route import RoutePlanner

    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    vehicle_ids = (1, 2, 3) if args.jitter else (2,)
    base_problems = []          # (problem dict, scenario idx)
    goals = []                  # (goal region, wb_rear_axle) per base problem
    for name in SCENARIOS:
        scenario, pp, _ = load_scenario_and_planning_problem(
            os.path.join(root, "example_scenarios", f"{name}.xml"))
        route = RoutePlanner(scenario, pp).plan_routes().retrieve_first_route()
        for vid in vehicle_ids:
            veh_cfg = VehicleConfiguration(id_type_vehicle=vid)
            base_problems.append((fleet_ops.problem_from_planner_setup(
                scenario, pp, route.reference_path, n_steps=n_steps,
                horizon_pad=args.cycles * args.freq + 10, dtype=dtype,
                vehicle=veh_cfg), len(goals)))
            goals.append((pp.goal, veh_cfg.wb_rear_axle))

    rng = np.random.default_rng(0)
    problems = []
    base_idx = []
    for i in range(args.fleet_size):
        base, gidx = base_problems[i % len(base_problems)]
        p = dict(base)
        if args.jitter:
            v_scale = float(rng.uniform(0.92, 1.08))
            d_off = float(rng.uniform(-0.25, 0.25))
            p["velocity"] = float(base["velocity"]) * v_scale
            x0_lon = np.asarray(base["x0_lon"], np.float64).copy()
            x0_lon[1] *= v_scale
            p["x0_lon"] = x0_lon
            x0_lat = np.asarray(base["x0_lat"], np.float64).copy()
            x0_lat[0] += d_off
            p["x0_lat"] = x0_lat
            p["desired_speed"] = float(base["desired_speed"]) * \
                float(rng.uniform(0.95, 1.05))
        problems.append(p)
        base_idx.append(gidx)
    scene, carry = fleet_ops.build_fleet_scene(problems, n_steps, dtype=dtype)

    veh_cfg = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[np.float32(x) for x in [
        veh_cfg.wheelbase, veh_cfg.wb_rear_axle, veh_cfg.a_max,
        veh_cfg.v_switch, np.tan(veh_cfg.delta_max) / veh_cfg.wheelbase,
        veh_cfg.v_delta_max, veh_cfg.length / 2, veh_cfg.width / 2]])
    static_grid = grid_ops.make_static_grid(args.level, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    K = static_grid.size

    if args.pallas:
        from commonroad_rp_jax.parallel import pallas_fleet
        run_scan = pallas_fleet.make_pallas_fleet_scan(
            scene, static_grid, dt, n_steps, replan_offset=args.freq,
            low_vel_threshold=4.0, horizon=n_steps * dt, n_cycles=args.cycles)
        run = lambda c, _s: run_scan(c)
    else:
        run = fleet_ops.make_fleet_rollout(
            make_fleet_mesh(), veh, static_grid, dt, n_steps,
            replan_offset=args.freq, low_vel_threshold=4.0,
            horizon=n_steps * dt, n_cycles=args.cycles)

    t0 = time.time()
    out = run(carry, scene)
    jax.block_until_ready(out)
    compile_s = time.time() - t0

    t0 = time.time()
    for _ in range(args.repeats):
        out = run(carry, scene)
    jax.block_until_ready(out)
    elapsed = (time.time() - t0) / args.repeats

    final_carry, metrics = out
    success = (np.asarray(metrics[4]) if args.pallas
               else np.asarray(metrics.fleet_success))
    problem_cycles = args.fleet_size * args.cycles
    result = {
        "fleet_size": args.fleet_size,
        "cycles": args.cycles,
        "replan_freq": args.freq,
        "jitter": args.jitter,
        "candidates_per_cycle": K,
        "wall_s_per_scan": round(elapsed, 4),
        "problem_cycles_per_sec": round(problem_cycles / elapsed, 1),
        "candidate_evals_per_sec": round(problem_cycles * K / elapsed, 1),
        "cycle_latency_ms_amortized": round(elapsed / args.cycles * 1e3, 2),
        "success_first_cycle": int(success[0]),
        "success_last_cycle": int(success[-1]),
        "compile_s": round(compile_s, 1),
        "backend": jax.default_backend(),
        "path": "pallas" if args.pallas else "xla",
    }

    if args.goal_check and args.pallas:
        from commonroad_rp_jax.models.state import ReactivePlannerState

        def position_only_states(goal, shifted_states):
            """Indices of recorded states whose POSITION satisfies some goal
            state (ignoring time/velocity/orientation constraints)."""
            hits = []
            for i, st in enumerate(shifted_states):
                for gs in goal.state_list:
                    if not (gs.position_shapes or gs.position_lanelets):
                        continue
                    in_shape = any(s.contains_point(st.position)
                                   for s in gs.position_shapes)
                    in_lanelet = False
                    if gs.position_lanelets and goal.lanelet_network:
                        in_lanelet = any(
                            goal.lanelet_network.find_lanelet_by_id(lid)
                            .contains_point(st.position)
                            for lid in gs.position_lanelets)
                    if in_shape or in_lanelet:
                        hits.append((i, gs))
                        break
            return hits

        alive = np.asarray(metrics[0])                       # [C, F]
        xs, ys = np.asarray(metrics[2]), np.asarray(metrics[3])
        thetas, vs = np.asarray(metrics[8]), np.asarray(metrics[9])
        per_scenario = {name: [0, 0] for name in SCENARIOS}  # [reached, total]
        # miss classification: a miss whose recorded
        # trace ENTERS the goal position outside the admissible time window
        # is a TIMING miss (measured distance in steps), velocity-interval
        # violations at in-position states are VELOCITY misses, traces that
        # never touch the goal position are PLANNING misses
        miss_detail = {name: {"timing": 0, "timing_steps": [], "velocity": 0,
                              "planning": 0, "dead": 0}
                       for name in SCENARIOS}
        for f in range(args.fleet_size):
            goal, wb_rear = goals[base_idx[f]]
            name = SCENARIOS[base_idx[f] // len(vehicle_ids)]
            per_scenario[name][1] += 1
            states = []
            died = False
            for c in range(args.cycles):
                if not alive[c, f]:
                    died = True
                    break
                state = ReactivePlannerState(
                    time_step=(c + 1) * args.freq,
                    position=np.array([xs[c, f], ys[c, f]]),
                    orientation=float(thetas[c, f]),
                    velocity=float(vs[c, f]), acceleration=0.0, yaw_rate=0.0,
                    steering_angle=0.0)
                states.append(state.shift_positions_to_center(wb_rear))
            reached_at = next((i for i, st in enumerate(states)
                               if goal.is_reached(st)), None)
            if reached_at is not None:
                per_scenario[name][0] += 1
                continue
            pos_hits = position_only_states(goal, states)
            if not pos_hits:
                miss_detail[name]["dead" if died else "planning"] += 1
                continue
            # in-position at some step: which constraint rejected it?
            time_dists = []
            vel_miss = False
            for i, gs in pos_hits:
                st = states[i]
                if gs.time_step is not None \
                        and not gs.time_step.contains(st.time_step):
                    time_dists.append(int(min(
                        abs(st.time_step - gs.time_step.start),
                        abs(st.time_step - gs.time_step.end))))
                elif gs.velocity is not None \
                        and not gs.velocity.contains(st.velocity):
                    vel_miss = True
            if time_dists:
                miss_detail[name]["timing"] += 1
                miss_detail[name]["timing_steps"].append(min(time_dists))
            elif vel_miss:
                miss_detail[name]["velocity"] += 1
            else:
                miss_detail[name]["planning"] += 1
        result["goal_reached"] = {
            name: f"{reached}/{total}"
            for name, (reached, total) in per_scenario.items()}
        result["miss_detail"] = {
            name: {k: v for k, v in d.items() if v}
            for name, d in miss_detail.items()
            if per_scenario[name][1] > per_scenario[name][0]}

    print(json.dumps(result))


if __name__ == "__main__":
    main()
