"""plan_scan device-side standstill fallback + stopping mode.

The device-resident replanning scan must cover the two reference behaviors
previously excluded from its scope:
  * the standstill fallback (reactive_planner.py:638-653, :667-713) as a
    ``where``-branch on the carry — a fully blocked scene at v ~ 0 keeps
    planning the host's exact standstill trajectory instead of freezing;
  * stopping mode (sampling.py:253-266 quintic longitudinal sampling,
    trajectories.py:545-550 filter_goals_behind, cost_function.py:60-62
    stopping cost) inside the scan.

Each test drives the host ``plan()`` loop and the scan on the same problem
and compares recorded states.
"""

import logging

import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.models.planner import ReactivePlanner
from commonroad_rp_jax.ops.collision import CorridorArrays
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.route import RoutePlanner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)

FREQ = 3   # replanning_frequency in the bundled ZAM_Over config


def _cfg(repo_root, **sampling):
    config = ReactivePlannerConfiguration.load(
        repo_root / "configurations" / "ZAM_Over-1_1.yaml", "ZAM_Over-1_1.xml")
    config.general.path_scenarios = str(repo_root / "example_scenarios") + "/"
    config.general.set_path_scenario("ZAM_Over-1_1.xml")
    config.update()
    config.debug.fast_scoring = True
    config.debug.kernel_dtype = "float32"
    for key, value in sampling.items():
        setattr(config.sampling, key, value)
    return config


def _make_planner(config, velocity=None):
    route = RoutePlanner(config.scenario, config.planning_problem) \
        .plan_routes().retrieve_first_route()
    planner = ReactivePlanner(config)
    planner.set_reference_path(route.reference_path)
    if velocity is not None:
        x0 = planner.x_0.copy()
        x0.velocity = velocity
        x0.yaw_rate = 0.0
        planner.reset(initial_state_cart=x0,
                      collision_checker=planner.collision_checker,
                      coordinate_system=planner.coordinate_system)
    return planner


def _squeeze_corridor(planner):
    """Block every candidate: squeeze the drivable band to a sliver."""
    corr = planner.collision_checker.corridor_for(planner.coordinate_system)
    planner.collision_checker._corridor_cache[planner.coordinate_system] = \
        CorridorArrays(d_lo=jnp.full_like(corr.d_lo, 0.001),
                       d_hi=jnp.full_like(corr.d_hi, 0.002))


def test_plan_scan_standstill_fallback_blocked(repo_root):
    """Fully blocked scene at v ~ 0: the host loop engages the standstill
    fallback every cycle; plan_scan's device branch must emit the same
    states (position frozen, v = 0, a[1] = -v0/dt, steering constant)."""
    n_cycles = 4

    host = _make_planner(_cfg(repo_root), velocity=0.04)
    _squeeze_corridor(host)
    host.record_state_and_input(host.x_0)
    optimal = None
    for _ in range(n_cycles * FREQ):
        count = len(host.record_state_list) - 1
        if count % FREQ == 0:
            host.set_desired_velocity(current_speed=host.x_0.velocity)
            optimal = host.plan()
            assert optimal is not None        # standstill fallback engaged
            offset = 1
        else:
            offset = 1 + count % FREQ
        host.record_state_and_input(optimal[0].state_list[offset])
        host.reset(initial_state_cart=host.record_state_list[-1],
                   initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                   collision_checker=host.collision_checker,
                   coordinate_system=host.coordinate_system)
    assert all(s.velocity == 0.0 for s in host.record_state_list[1:])

    planner = _make_planner(_cfg(repo_root), velocity=0.04)
    _squeeze_corridor(planner)
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    planner.record_state_and_input(planner.x_0)
    info = planner.plan_scan(n_cycles)

    # the fallback keeps the scan alive at cost 0 instead of freezing
    assert info["cycles_run"] == n_cycles
    assert all(c == 0.0 for c in info["best_cost"])
    assert all(info["found"])

    want, got = host.record_state_list, planner.record_state_list
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.time_step == b.time_step
        np.testing.assert_allclose(b.position, a.position, atol=1e-4)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=1e-6)
        np.testing.assert_allclose(b.acceleration, a.acceleration, atol=1e-5)
        np.testing.assert_allclose(b.orientation, a.orientation, atol=1e-5)
        np.testing.assert_allclose(b.steering_angle, a.steering_angle,
                                   atol=1e-6)


def test_plan_scan_stopping_mode_matches_host(repo_root):
    """Stopping mode through the scan: quintic lon targets toward the stop
    position, stopping cost (w_a = 1), goal-behind filtering — same driven
    states as the host plan() loop until the vehicle halts."""
    stop_offset = 8.0

    host = _make_planner(_cfg(repo_root, longitudinal_mode="stopping"),
                         velocity=8.0)
    host.record_state_and_input(host.x_0)
    stop_s = host.x_0_cl[0][0] + stop_offset
    optimal = None
    for _ in range(60):
        count = len(host.record_state_list) - 1
        if count % FREQ == 0:
            host.set_desired_lon_position(stop_s)
            new = host.plan()
            if new is None:
                break
            optimal = new
            offset = 1
        else:
            offset = 1 + count % FREQ
        host.record_state_and_input(optimal[0].state_list[offset])
        host.reset(initial_state_cart=host.record_state_list[-1],
                   initial_state_curv=(optimal[2][offset], optimal[3][offset]),
                   collision_checker=host.collision_checker,
                   coordinate_system=host.coordinate_system)
        if host.x_0.velocity <= 0.05:
            break
    assert host.x_0.velocity < 2.0            # host loop reached the halt

    planner = _make_planner(_cfg(repo_root, longitudinal_mode="stopping"),
                            velocity=8.0)
    planner.record_state_and_input(planner.x_0)
    planner.set_desired_lon_position(stop_s)
    info = planner.plan_scan(10)

    want = host.record_state_list
    got = planner.record_state_list
    assert len(got) >= len(want)
    # strict parity while the cost landscape is well-separated; approaching
    # the halt the stopping cost flattens across neighbouring s-targets and
    # exact-cost ties resolve by bundle order, which differs between the
    # host's np.unique grids and the device grids (doc/conformance.md
    # divergence 1) — compare qualitatively there.
    for a, b in zip(want, got):
        assert a.time_step == b.time_step
        if a.velocity < 2.5:
            break
        np.testing.assert_allclose(b.position, a.position, atol=5e-3)
        np.testing.assert_allclose(b.velocity, a.velocity, atol=5e-3)
    # both paths halt at the stop target
    host_final = np.asarray(want[-1].position)
    scan_final = np.asarray(got[len(want) - 1].position)
    np.testing.assert_allclose(scan_final, host_final, atol=0.5)
    assert got[len(want) - 1].velocity < 2.0
    assert info["cycles_run"] * FREQ + 1 >= len(want)


def test_plan_scan_cache_lru_mode_alternation(repo_root):
    """A velocity -> stopping -> velocity mission builds each scan ONCE: the
    plan_scan cache is an LRU over the last few built scans, so alternating
    longitudinal modes must not retrace (~1 s per rebuild) on every switch."""
    planner = _make_planner(_cfg(repo_root), velocity=8.0)
    v0 = planner.x_0.velocity
    stop_s = planner.x_0_cl[0][0] + 8.0

    def velocity_mode():
        planner.config.sampling.longitudinal_mode = "velocity_keeping"
        planner._desired_speed = None
        planner.set_desired_velocity(desired_velocity=20.0, current_speed=v0)

    def stopping_mode():
        planner.config.sampling.longitudinal_mode = "stopping"
        planner.set_desired_lon_position(stop_s)

    velocity_mode()
    planner.plan_scan(2, record=False)
    assert planner._plan_scan_builds == 1
    stopping_mode()
    planner.plan_scan(2, record=False)
    assert planner._plan_scan_builds == 2
    velocity_mode()
    planner.plan_scan(2, record=False)
    assert planner._plan_scan_builds == 2          # cache hit, no rebuild
    stopping_mode()
    planner.plan_scan(2, record=False)
    assert planner._plan_scan_builds == 2          # cache hit, no rebuild
