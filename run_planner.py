"""End-to-end driver: config -> route -> planner -> cyclic replanning -> evaluation.

Mirror of the reference driver (reference: run_planner.py:25-126) on the
device-batched planner.  Usage:

    python run_planner.py [--scenario ZAM_Over-1_1] [--platform cpu|gpu]
                          [--max-steps N] [--evaluate] [--plot]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_config(scenario: str, root: str = ROOT):
    """The bundled configuration of ``scenario`` with its scenario file
    attached (reference run_planner.py:28-32)."""
    from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration

    config = ReactivePlannerConfiguration.load(
        os.path.join(root, "configurations", f"{scenario}.yaml"),
        f"{scenario}.xml")
    config.general.path_scenarios = os.path.join(root, "example_scenarios") \
        + os.sep
    config.general.set_path_scenario(f"{scenario}.xml")
    config.update()
    return config


def build_planner(config):
    """Route + planner on the first route's reference path (reference
    run_planner.py:39-50)."""
    from commonroad_rp_jax.models.planner import ReactivePlanner
    from commonroad_rp_jax.utils.route import RoutePlanner

    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    return planner


def drive_host_loop(planner, config, max_steps: int, stop_s=None,
                    sampling_iteration_outside: bool = False,
                    verbose: bool = False) -> None:
    """The reference driver's cyclic replanning loop (run_planner.py:53-115):
    ``plan()`` every ``replanning_frequency`` steps, walking the previous
    optimum in between, until the goal (or, with ``stop_s``, a halt)."""
    logger = logging.getLogger("RP_LOGGER")
    optimal = None
    while not planner.goal_reached():
        current_count = len(planner.record_state_list) - 1
        if current_count >= max_steps:
            logger.warning("Aborting after %d steps without reaching goal",
                           current_count)
            break
        if stop_s is not None and planner.x_0.velocity <= 0.05:
            logger.info("Vehicle halted at the stop target")
            break

        plan_new_trajectory = \
            current_count % config.planning.replanning_frequency == 0
        if plan_new_trajectory:
            if stop_s is not None:
                planner.set_desired_lon_position(stop_s)
            else:
                planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            if sampling_iteration_outside:
                # per-level escalation driven by the caller (run_planner.py:72-75)
                optimal = None
                level = 1
                while optimal is None and level < planner.sampling_level:
                    optimal = planner.plan(level)
                    level += 1
            else:
                optimal = planner.plan()
            if not optimal:
                logger.error("Planner returned no trajectory — stopping")
                break
            planner.record_state_and_input(optimal[0].state_list[1])
            planner.reset(initial_state_cart=planner.record_state_list[-1],
                          initial_state_curv=(optimal[2][1], optimal[3][1]),
                          collision_checker=planner.collision_checker,
                          coordinate_system=planner.coordinate_system)
        else:
            # continue on the previous optimal trajectory (run_planner.py:94-107)
            temp = current_count % config.planning.replanning_frequency
            planner.record_state_and_input(optimal[0].state_list[1 + temp])
            planner.reset(initial_state_cart=planner.record_state_list[-1],
                          initial_state_curv=(optimal[2][1 + temp],
                                              optimal[3][1 + temp]),
                          collision_checker=planner.collision_checker,
                          coordinate_system=planner.coordinate_system)
        if verbose:
            print(f"current time step: {current_count}", flush=True)


def drive_scan_loop(planner, config, max_steps: int, stop_s=None,
                    chunk: int = 12, verbose: bool = False) -> list:
    """The same loop as device-resident ``plan_scan`` dispatches of
    ``chunk`` replanning cycles each; returns the per-dispatch infos."""
    logger = logging.getLogger("RP_LOGGER")
    if stop_s is None:
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    scan_infos = []
    while not planner.goal_reached():
        if len(planner.record_state_list) - 1 >= max_steps:
            logger.warning("Aborting after %d steps without reaching goal",
                           len(planner.record_state_list) - 1)
            break
        if stop_s is not None and planner.x_0.velocity <= 0.05:
            logger.info("Vehicle halted at the stop target")
            break
        info = planner.plan_scan(chunk)
        scan_infos.append(info)
        if verbose:
            print(f"plan_scan: {info['cycles_run']} cycles, "
                  f"{info['steps']} steps, goal={info['goal_reached']}, "
                  f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.2f}"
                  " ms/cycle", flush=True)
        if info["cycles_run"] < chunk and not info["goal_reached"]:
            logger.error("plan_scan found no trajectory — stopping")
            break
    return scan_infos


def drive_mission(planner, config, max_steps: int = 400, chunk: int = 12,
                  verbose: bool = False) -> dict:
    """Stop-at-goal mission: the reference's two longitudinal modes
    (reactive_planner.py:309-347 velocity-keeping + :349-376 stopping)
    composed into one run, every planning cycle through the device-resident
    ``plan_scan``.

    Phases: CRUISE (velocity-keeping) until the goal region is entered
    inside its admissible time window, then BRAKE (tracked deceleration
    profile toward a computed stop point), then STOP (stopping-mode
    quintics to rest).  A stopping quintic must fit the horizon
    (t_stop ~ 2 d / v <= h), which bounds the hand-over speed; the
    velocity-keeping sampler tracks a braking profile at ~1.7 m/s^2
    effective (measured, lag included), so the stop point is placed with a
    conservative 1.5 and the profile leads the position by ~1 s of travel.

    Returns a dict: success, goal_entered, halted, final_v, final_s,
    stop_target, steps, cycles, scan_infos.
    """
    logger = logging.getLogger("RP_LOGGER")
    scan_infos = []
    a_br = 1.5
    v_handover = max(2.0, min(6.0, 0.55 * 2.5 * planner.horizon))
    reach_h = max(0.45 * v_handover * planner.horizon, 3.0)
    phase = "cruise"
    goal_entered = False
    stop_target = None
    stop_retargets = 0
    while True:
        if len(planner.record_state_list) - 1 >= max_steps:
            logger.warning("Mission aborted after %d steps",
                           len(planner.record_state_list) - 1)
            break
        if not planner.x_0_cl:
            planner.x_0_cl = planner._compute_initial_states(planner.x_0)
        cur_s = float(planner.x_0_cl[0][0])
        v = planner.x_0.velocity
        n_cycles = chunk
        if phase == "cruise":
            planner.set_desired_velocity(current_speed=v)
        elif phase == "brake":
            if stop_target is None:
                # fixed stop point: brake distance + sampler reach +
                # half-second tracking-lag margin
                stop_target = cur_s \
                    + (v * v - v_handover ** 2) / (2.0 * a_br) \
                    + reach_h + 0.5 * v
                logger.info("Mission: braking toward stop at s = %.2f",
                            stop_target)
            remaining = stop_target - cur_s
            if remaining < 2.0 and v > 0.5:
                # overshot the planned stop point — re-target ahead
                stop_target = cur_s + max(0.45 * v * planner.horizon, 3.0)
                remaining = stop_target - cur_s
                logger.info("Mission: re-targeting stop to s = %.2f",
                            stop_target)
            if remaining <= max(reach_h, 0.45 * v * planner.horizon):
                # a stopping quintic from the CURRENT speed fits the
                # horizon — hand over now
                phase = "stop"
                config.sampling.longitudinal_mode = "stopping"
                planner.set_desired_lon_position(stop_target)
                logger.info("Mission: stopping phase at s = %.2f "
                            "(%.1f m to stop target)", cur_s, remaining)
            else:
                # profile speed one second of travel AHEAD of the current
                # position (tracking-lag lead)
                v_des = max(v_handover, float(np.sqrt(max(
                    2.0 * a_br * (remaining - reach_h - v), 0.0))))
                planner.set_desired_velocity(desired_velocity=v_des,
                                             current_speed=v)
                n_cycles = 3
        if phase == "stop" and v <= 0.05:
            logger.info("Mission: halted at s = %.2f", cur_s)
            break
        info = planner.plan_scan(n_cycles,
                                 stop_on_goal=(phase == "cruise"))
        scan_infos.append(info)
        if verbose:
            print(f"plan_scan[{phase}]: {info['cycles_run']} cycles, "
                  f"{info['steps']} steps, goal={info['goal_reached']}, "
                  f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.2f}"
                  " ms/cycle", flush=True)
        if phase == "cruise" and info["goal_reached"]:
            goal_entered = True
            phase = "brake"
            logger.info("Mission: goal region entered — braking")
            continue
        if info["cycles_run"] == 0:
            if phase == "stop" and planner.x_0.velocity > 0.05 \
                    and stop_retargets < 3:
                # rolled past the stop point before rest — nudge the target
                # ahead of the current position and keep stopping
                stop_retargets += 1
                cur_s = float(planner.x_0_cl[0][0])
                v = planner.x_0.velocity
                stop_target = cur_s + max(0.45 * v * planner.horizon, 1.5)
                planner.set_desired_lon_position(stop_target)
                logger.info("Mission: stop re-target %d to s = %.2f",
                            stop_retargets, stop_target)
                continue
            logger.error("plan_scan found no trajectory — stopping")
            break
    final_v = planner.x_0.velocity
    final_s = float(planner.x_0_cl[0][0]) if planner.x_0_cl else None
    halted = final_v <= 0.05
    success = goal_entered and halted and final_s is not None and \
        stop_target is not None and abs(final_s - stop_target) < 5.0
    return dict(success=success, goal_entered=goal_entered, halted=halted,
                final_v=final_v, final_s=final_s, stop_target=stop_target,
                steps=len(planner.record_state_list) - 1,
                cycles=sum(i["cycles_run"] for i in scan_infos),
                scan_infos=scan_infos)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", default="ZAM_Over-1_1")
    parser.add_argument("--platform", default=None,
                        help="force a jax platform (cpu / gpu)")
    parser.add_argument("--dtype", default=None, choices=["float32", "float64"],
                        help="planner kernel dtype (default: float64 on cpu, "
                             "float32 on gpu)")
    parser.add_argument("--max-steps", type=int, default=300)
    parser.add_argument("--evaluate", action="store_true",
                        help="run the solution-feasibility evaluation harness")
    parser.add_argument("--sampling-iteration-outside", action="store_true",
                        help="iterate sampling levels in the driver instead of "
                             "inside plan() (run_planner.py:59-75 mode)")
    parser.add_argument("--plot", action="store_true",
                        help="save final-trajectory plot to output/")
    parser.add_argument("--fast", action="store_true",
                        help="score candidates with the fused scorer "
                             "(config.debug.fast_scoring; the default on gpu)")
    parser.add_argument("--scan", action="store_true",
                        help="drive the whole replanning loop as device-"
                             "resident plan_scan dispatches (implies --fast; "
                             "the fastest per-cycle path)")
    parser.add_argument("--stop-at", type=float, default=None, metavar="DS",
                        help="stopping mode: plan to a halt DS meters ahead "
                             "along the reference path (sets "
                             "sampling.longitudinal_mode=stopping; the loop "
                             "ends when the vehicle halts)")
    parser.add_argument("--mission", action="store_true",
                        help="stop-at-goal mission: velocity-keeping "
                             "plan_scan to the goal region, then stopping-"
                             "mode plan_scan to a standstill at the goal "
                             "center — the reference's two longitudinal "
                             "modes composed end-to-end on device "
                             "(implies --scan)")
    args = parser.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from commonroad_rp_jax.backend import enable_compile_cache
    from commonroad_rp_jax.utils.logger import initialize_logger

    config = load_config(args.scenario)
    enable_compile_cache()

    if args.mission:
        args.scan = True
    if args.scan:
        args.fast = True
    if args.stop_at is not None:
        config.sampling.longitudinal_mode = "stopping"
    if args.fast and args.dtype and args.dtype != "float32":
        parser.error(f"--fast requires float32 kernels (the fused scorer "
                     f"is float32 only); drop --dtype or --fast")

    # unset options resolve from the backend (commonroad_rp_jax.backend)
    if args.dtype:
        config.debug.kernel_dtype = args.dtype
    if args.fast:
        config.debug.fast_scoring = True
        config.debug.kernel_dtype = "float32"

    initialize_logger(config)
    logger = logging.getLogger("RP_LOGGER")
    logger.info("Scenario %s on platform %s", args.scenario, jax.default_backend())

    planner = build_planner(config)

    # **************************
    # Run planning (run_planner.py:53-115)
    # **************************
    planner.record_state_and_input(planner.x_0)
    t_start = time.time()

    stop_s = None
    if args.stop_at is not None:
        if not planner.x_0_cl:
            planner.x_0_cl = planner._compute_initial_states(planner.x_0)
        stop_s = float(planner.x_0_cl[0][0]) + args.stop_at
        planner.set_desired_lon_position(stop_s)
        logger.info("Stopping mode: target s = %.2f (+%.1f m)", stop_s,
                    args.stop_at)

    if args.mission:
        goal_s = planner.goal_center_s()
        if goal_s is None:
            parser.error("--mission requires a goal with a position "
                         "constraint")
        result = drive_mission(planner, config, max_steps=args.max_steps,
                               verbose=True)
        wall = time.time() - t_start
        reached = result["success"]
        n_cycles = result["cycles"]
        print(f"mission: goal_entered={result['goal_entered']} "
              f"halted={result['halted']} v={result['final_v']:.3f} "
              f"s={result['final_s']:.2f} "
              f"stop_target={result['stop_target']}", flush=True)
        print(f"goal_reached={reached} steps={result['steps']} "
              f"wall={wall:.2f}s cycles={n_cycles} "
              f"ms_per_cycle={wall / max(n_cycles, 1) * 1e3:.2f}", flush=True)
        if args.evaluate:
            from commonroad_rp_jax.utils.evaluation import run_evaluation
            solution, feasibility = run_evaluation(
                planner.config, planner.record_state_list,
                planner.record_input_list)
            print(f"state transitions feasible: "
                  f"{sum(feasibility)}/{len(feasibility)}")
        return 0 if reached else 1

    if args.scan:
        # device-resident loop: chunks of replanning cycles per dispatch
        scan_infos = drive_scan_loop(planner, config, args.max_steps,
                                     stop_s=stop_s, verbose=True)
        wall = time.time() - t_start
        n_steps = len(planner.record_state_list) - 1
        reached = planner.goal_reached()
        if stop_s is not None:
            final_v = planner.x_0.velocity
            final_s = float(planner.x_0_cl[0][0]) if planner.x_0_cl else None
            reached = final_v <= 0.05 and final_s is not None and \
                abs(final_s - stop_s) < 5.0
            print(f"stopping: halted={final_v <= 0.05} v={final_v:.3f} "
                  f"s={final_s:.2f} target={stop_s:.2f}", flush=True)
        n_cycles = sum(i["cycles_run"] for i in scan_infos)
        print(f"goal_reached={reached} steps={n_steps} wall={wall:.2f}s "
              f"cycles={n_cycles} "
              f"ms_per_cycle={wall / max(n_cycles, 1) * 1e3:.2f}", flush=True)
        if args.evaluate:
            from commonroad_rp_jax.utils.evaluation import run_evaluation
            solution, feasibility = run_evaluation(
                planner.config, planner.record_state_list,
                planner.record_input_list)
            print(f"state transitions feasible: "
                  f"{sum(feasibility)}/{len(feasibility)}")
        return 0 if reached else 1

    drive_host_loop(planner, config, args.max_steps, stop_s=stop_s,
                    sampling_iteration_outside=args.sampling_iteration_outside,
                    verbose=True)

    wall = time.time() - t_start
    n_steps = len(planner.record_state_list) - 1
    reached = planner.goal_reached()
    if stop_s is not None:
        final_v = planner.x_0.velocity
        final_s = float(planner.x_0_cl[0][0]) if planner.x_0_cl else None
        reached = final_v <= 0.05 and final_s is not None and \
            abs(final_s - stop_s) < 5.0
        print(f"stopping: halted={final_v <= 0.05} v={final_v:.3f} "
              f"s={final_s:.2f} target={stop_s:.2f}", flush=True)
    if planner.planning_times:
        ordered = sorted(planner.planning_times)
        print(f"goal_reached={reached} steps={n_steps} wall={wall:.2f}s "
              f"cycles={len(ordered)} p50_cycle={ordered[len(ordered)//2]:.4f}s "
              f"min_cycle={ordered[0]:.4f}s max_cycle={ordered[-1]:.4f}s",
              flush=True)
        print("cycle_times_ms="
              f"{[round(1e3 * t, 1) for t in planner.planning_times]}",
              flush=True)
    else:
        print("no planning cycles ran", flush=True)

    if args.plot:
        from commonroad_rp_jax.utils.visualization import plot_final_trajectory
        plot_final_trajectory(config.scenario, config.planning_problem,
                              planner.record_state_list, config)

    # **************************
    # Evaluate results (run_planner.py:121-126)
    # **************************
    if args.evaluate:
        from commonroad_rp_jax.utils.evaluation import run_evaluation
        solution, feasibility = run_evaluation(
            planner.config, planner.record_state_list, planner.record_input_list)
        print(f"state transitions feasible: {sum(feasibility)}/{len(feasibility)}")

    return 0 if reached else 1


if __name__ == "__main__":
    raise SystemExit(main())
