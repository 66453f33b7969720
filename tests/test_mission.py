"""Stop-at-goal mission e2e: velocity-keeping to the
goal region, braking, then stopping mode to standstill — the reference's
two longitudinal modes (reactive_planner.py:309-347 + :349-376) composed
into one run, with EVERY planning cycle through the device-resident
``plan_scan`` (run_planner.drive_mission)."""

import logging
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner
from run_planner import drive_mission

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

pytestmark = pytest.mark.slow


def test_mission_zam_over_stop_at_goal(repo_root):
    """ZAM_Over: enter the goal region within its [0, 30] time window at
    cruise speed, then brake and halt at the computed stop target —
    entirely through plan_scan dispatches."""
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"

    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes() \
        .retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    planner.record_state_and_input(planner.x_0)

    assert planner.goal_center_s() == pytest.approx(93.0, abs=2.0)
    result = drive_mission(planner, config, max_steps=320)

    assert result["goal_entered"], result
    assert result["halted"], result
    assert result["success"], result
    # goal entry happened inside the cruise phase at the pinned step count
    # (the velocity-keeping path is the pinned 27-step ZAM_Over drive)
    assert result["steps"] <= 320
    velocities = [s.velocity for s in planner.record_state_list]
    assert velocities[-1] <= 0.05
    # monotone-ish: the mission never reverses
    assert min(velocities) >= -1e-5
    # every recorded state came from plan_scan dispatches
    assert result["cycles"] * config.planning.replanning_frequency + 3 \
        >= result["steps"]
