"""Checkpoint / resume of planner and fleet state."""

import logging

import numpy as np

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.utils import checkpoint
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


def _make_planner(repo_root):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    route = RoutePlanner(config.scenario,
                         config.planning_problem).plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    return planner, config


def test_planner_checkpoint_resume(repo_root, tmp_path):
    planner, config = _make_planner(repo_root)
    planner.record_state_and_input(planner.x_0)

    # run a few cycles
    optimal = None
    for _ in range(6):
        count = len(planner.record_state_list) - 1
        freq = config.planning.replanning_frequency
        if count % freq == 0:
            planner.set_desired_velocity(current_speed=planner.x_0.velocity)
            optimal = planner.plan()
            offset = 1
        else:
            offset = 1 + count % freq
        planner.record_state_and_input(optimal[0].state_list[offset])
        planner.reset(initial_state_cart=planner.record_state_list[-1],
                      initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_planner_state(planner, path)

    # fresh planner resumes from the checkpoint
    resumed, _ = _make_planner(repo_root)
    checkpoint.load_planner_state(resumed, path)
    assert len(resumed.record_state_list) == len(planner.record_state_list)
    np.testing.assert_allclose(resumed.x_0.position, planner.x_0.position)
    np.testing.assert_allclose(resumed.x_0_cl[0], planner.x_0_cl[0])
    assert resumed.x_0.time_step == planner.x_0.time_step

    # the resumed planner can continue planning
    resumed.set_desired_velocity(current_speed=resumed.x_0.velocity)
    assert resumed.plan() is not None


def test_fleet_carry_roundtrip(tmp_path):
    import jax.numpy as jnp

    from commonroad_rp_jax.parallel.fleet import FleetCarry

    carry = FleetCarry(
        x0_lon=jnp.asarray(np.random.rand(4, 3), jnp.float32),
        x0_lat=jnp.asarray(np.random.rand(4, 3), jnp.float32),
        orientation=jnp.asarray(np.random.rand(4), jnp.float32),
        velocity=jnp.asarray(np.random.rand(4), jnp.float32),
        time_step=jnp.asarray([0, 3, 6, 9], jnp.int32),
        alive=jnp.asarray([True, True, False, True]),
        kappa=jnp.asarray(np.random.rand(4), jnp.float32),
        px=jnp.asarray(np.random.rand(4), jnp.float32),
        py=jnp.asarray(np.random.rand(4), jnp.float32))
    path = str(tmp_path / "fleet.npz")
    checkpoint.save_fleet_carry(carry, cycle_index=7, path=path)
    restored, cycle = checkpoint.load_fleet_carry(path)
    assert cycle == 7
    for field in FleetCarry._fields:
        np.testing.assert_array_equal(np.asarray(getattr(restored, field)),
                                      np.asarray(getattr(carry, field)))
