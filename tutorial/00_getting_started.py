"""Getting started with the device-batched reactive planner.

Runnable step-by-step walkthrough mirroring the reference tutorial notebook
(reference: tutorial/00_getting_started.ipynb): load a scenario and config,
plan a route, run one planning cycle, inspect the result, then run the full
cyclic replanning loop and evaluate the solution.

    python tutorial/00_getting_started.py [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default=None)
args = parser.parse_args()

import jax

if args.platform:
    jax.config.update("jax_platforms", args.platform)

# %% 1. Load configuration and scenario ------------------------------------
# The YAML configs use the same fields as the reference
# (commonroad_rp/utility/config.py); scenario files are CommonRoad XML.
from commonroad_rp_jax import ReactivePlannerConfiguration

root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.chdir(root)

config = ReactivePlannerConfiguration.load(
    "configurations/ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
config.update()
print(f"scenario: {config.scenario.scenario_id}, "
      f"dt={config.planning.dt}, horizon={config.planning.planning_horizon}s")

# %% 2. Plan a route and build the planner ---------------------------------
from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.route import RoutePlanner

route = RoutePlanner(config.scenario,
                     config.planning_problem).plan_routes().retrieve_first_route()
print(f"route through lanelets {route.lanelet_ids}, "
      f"reference path {len(route.reference_path)} vertices")

planner = ReactivePlanner(config)
planner.set_reference_path(route.reference_path)

# %% 3. One planning cycle --------------------------------------------------
# The whole candidate bundle (grid -> rollout -> feasibility -> cost ->
# collision -> argmin) is evaluated as one jitted device program.
planner.set_desired_velocity(current_speed=planner.x_0.velocity)
cartesian, curvilinear, lon_samples, lat_samples = planner.plan()

print(f"selected trajectory cost: {planner.optimal_cost:.2f}")
print(f"kinematically infeasible candidates: {planner.infeasible_count_kinematics}")
print(f"rejection reasons: {planner.infeasible_reason_dict}")
print(f"first states: v={cartesian.state_list[0].velocity:.2f} -> "
      f"v={cartesian.state_list[-1].velocity:.2f}")

# %% 4. Cyclic replanning to the goal --------------------------------------
planner.record_state_and_input(planner.x_0)
optimal = None
while not planner.goal_reached() and len(planner.record_state_list) < 200:
    count = len(planner.record_state_list) - 1
    freq = config.planning.replanning_frequency
    if count % freq == 0:
        planner.set_desired_velocity(current_speed=planner.x_0.velocity)
        optimal = planner.plan()
        if optimal is None:
            print("planning failed"); break
        offset = 1
    else:
        offset = 1 + count % freq
    planner.record_state_and_input(optimal[0].state_list[offset])
    planner.reset(initial_state_cart=planner.record_state_list[-1],
                  initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                  collision_checker=planner.collision_checker,
                  coordinate_system=planner.coordinate_system)

print(f"goal reached: {planner.goal_reached()} after "
      f"{len(planner.record_state_list) - 1} steps; "
      f"p50 cycle latency: "
      f"{sorted(planner.planning_times)[len(planner.planning_times) // 2] * 1e3:.1f} ms")

# %% 5. Evaluate the solution ----------------------------------------------
# KS-model input reconstruction per state transition + validity check
# (the reference's physics-level oracle).
from commonroad_rp_jax.utils.evaluation import run_evaluation

solution, feasibility = run_evaluation(config, planner.record_state_list,
                                       planner.record_input_list)
print(f"feasible transitions: {sum(feasibility)}/{len(feasibility)}")

# %% 6. Visualize -----------------------------------------------------------
from commonroad_rp_jax.utils.visualization import plot_final_trajectory

os.makedirs("output", exist_ok=True)
plot_final_trajectory(config.scenario, config.planning_problem,
                      planner.record_state_list, config,
                      save_path="output/tutorial_final_trajectory.png")
print("plot saved to output/tutorial_final_trajectory.png")

# %% 7. Fast scoring (optional) ---------------------------------------------
# Score candidates with the fused scorer instead of the dense conformance
# program: same selected trajectory, exact rejection counters and
# per-constraint reason dict. On a GPU backend this is already the DEFAULT
# (kernel_dtype "auto" resolves to float32 + fast_scoring on); the explicit
# settings below force it on CPU too.
config.debug.fast_scoring = True
config.debug.kernel_dtype = "float32"
fast_planner = ReactivePlanner(config)
fast_planner.set_reference_path(route.reference_path)
fast_planner.set_desired_velocity(current_speed=fast_planner.x_0.velocity)
fast_result = fast_planner.plan()
print("fast path optimal cost:", fast_planner.optimal_cost)


# ## 8. One-dispatch replanning: plan_scan
# The whole cyclic replanning loop as a single device dispatch (grid
# generation, fused level-escalated scoring, winner re-roll, and state
# advance all on device). Scope: velocity-keeping within the fast-path
# scope.
scan_planner = ReactivePlanner(config)
scan_planner.set_reference_path(route.reference_path)
scan_planner.set_desired_velocity(current_speed=scan_planner.x_0.velocity)
scan_planner.record_state_and_input(scan_planner.x_0)
info = scan_planner.plan_scan(n_cycles=12)
print(f"goal={info['goal_reached']} cycles={info['cycles_run']} "
      f"steps={info['steps']} "
      f"{info['wall_time'] / max(info['cycles_run'], 1) * 1e3:.1f} ms/cycle")
