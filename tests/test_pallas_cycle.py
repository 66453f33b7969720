"""The fused scorer (ops.cycle.score_candidates) vs. the XLA stage chain.

The scorer must reproduce the masked candidate costs of the separate stages
(rollout + cost + corridor + obstacle collision, +inf where infeasible or
colliding), its statistics row and the fleet form.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cost as cost_ops
from commonroad_rp_jax.ops import frenet as frenet_ops
from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.ops import cycle as cycle_ops


def _setup(level=1, v0=15.0, low_vel=False, with_obstacle=True):
    dtype = jnp.float32
    n_steps, dt = 20, 0.1
    xs = np.linspace(0.0, 200.0, 400)
    ys = 6.0 * np.sin(xs / 70.0)
    ref = frenet_ops.from_polyline(np.stack([xs, ys], axis=1), dtype=dtype)
    P = ref.s.shape[0]
    corridor = collision_ops.CorridorArrays(
        d_lo=jnp.full(P, -4.0, dtype), d_hi=jnp.full(P, 4.0, dtype))

    from commonroad_rp_jax.utils.config import VehicleConfiguration
    vc = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[jnp.asarray(x, dtype) for x in [
        vc.wheelbase, vc.wb_rear_axle, vc.a_max, vc.v_switch,
        np.tan(vc.delta_max) / vc.wheelbase, vc.v_delta_max,
        vc.length / 2, vc.width / 2]])

    static_grid = grid_ops.make_static_grid(level, 0.4, n_steps * dt, dt,
                                            -3.0, 3.0, 4)
    x0_lon = jnp.asarray([40.0, v0, 0.2], dtype)
    x0_lat = jnp.asarray([0.4, 0.05, 0.0], dtype)
    cl, ca, tl = grid_ops.velocity_keeping_candidates(
        x0_lon, x0_lat, jnp.asarray(max(0.0, v0 - 4.0), dtype),
        jnp.asarray(v0 + 4.0, dtype), jnp.asarray(low_vel), static_grid)

    T = n_steps + 1
    if with_obstacle:
        pose = np.zeros((1, T, 3), np.float32)
        pose[0, :, 0] = 70.0
        pose[0, :, 1] = 4.5
        obstacles = collision_ops.ObstacleArrays(
            pose=jnp.asarray(pose),
            half_ext=jnp.asarray([[2.5, 1.0]], dtype),
            valid=jnp.ones((1, T), dtype=bool))
    else:
        obstacles = collision_ops.ObstacleArrays(
            pose=jnp.zeros((0, T, 3), dtype),
            half_ext=jnp.zeros((0, 2), dtype),
            valid=jnp.zeros((0, T), dtype=bool))

    return dict(ref=ref, corridor=corridor, veh=veh, cl=cl, ca=ca, tl=tl,
                obstacles=obstacles, dt=dt, n_steps=n_steps,
                x0_theta=jnp.asarray(0.08, dtype), low_vel=low_vel,
                desired_v=jnp.asarray(v0, dtype))


def _xla_masked_costs(cfg):
    rollout = kin_ops.rollout(cfg["cl"], cfg["ca"], cfg["tl"], cfg["ref"],
                              cfg["veh"], cfg["x0_theta"], cfg["dt"],
                              cfg["n_steps"], cfg["low_vel"])
    costs = cost_ops.default_cost(rollout, w_a=jnp.float32(5.0),
                                  desired_d=jnp.float32(0.0),
                                  desired_speed=cfg["desired_v"])
    collides = collision_ops.check_collisions(
        rollout.x, rollout.y, rollout.theta_gl, cfg["obstacles"], None,
        cfg["veh"].half_length, cfg["veh"].half_width, cfg["veh"].wb_rear_axle)
    collides = collides | collision_ops.check_corridor(
        rollout.s, rollout.d, rollout.theta_cl, cfg["ref"].s, cfg["corridor"],
        cfg["veh"].half_length, cfg["veh"].half_width, cfg["veh"].wb_rear_axle)
    ok = rollout.feasible & ~collides
    return np.where(np.asarray(ok), np.asarray(costs), np.inf)


def _cost_params(desired_v, w_a=5.0, desired_s=0.0):
    return cycle_ops.CostParams(
        w_a=jnp.float32(w_a), desired_d=jnp.float32(0.0),
        desired_speed=jnp.asarray(desired_v, jnp.float32),
        desired_s=jnp.float32(desired_s))


def _score(cfg, cl, ca, tl, goal_valid, cost_params, cost_structure,
           ref_s_last=None):
    return cycle_ops.score_candidates(
        cl, ca, tl, goal_valid, cfg["ref"], cfg["veh"], cfg["obstacles"],
        cfg["corridor"], cfg["x0_theta"], cost_params,
        jnp.asarray(cfg["low_vel"]), ref_s_last, dt=cfg["dt"],
        n_steps=cfg["n_steps"], cost_structure=cost_structure,
        constraint_flags=(True,) * 5)


def _pallas_masked_costs(cfg):
    masked, kin, _ = _score(cfg, cfg["cl"], cfg["ca"], cfg["tl"],
                            jnp.ones(cfg["cl"].shape[0], dtype=bool),
                            _cost_params(cfg["desired_v"]),
                            ("default", True, False))
    return np.asarray(masked), np.asarray(kin)


@pytest.mark.parametrize("v0,low_vel", [(15.0, False), (2.5, True)])
def test_pallas_scoring_matches_xla(v0, low_vel):
    cfg = _setup(v0=v0, low_vel=low_vel)
    want = _xla_masked_costs(cfg)
    got, kin = _pallas_masked_costs(cfg)

    # statistics row: finite exactly where the XLA rollout is kinematically
    # feasible (collision not yet applied)
    rollout = kin_ops.rollout(cfg["cl"], cfg["ca"], cfg["tl"], cfg["ref"],
                              cfg["veh"], cfg["x0_theta"], cfg["dt"],
                              cfg["n_steps"], cfg["low_vel"])
    np.testing.assert_array_equal(np.isfinite(kin),
                                  np.asarray(rollout.feasible))

    finite_want = np.isfinite(want)
    finite_got = np.isfinite(got)
    np.testing.assert_array_equal(finite_got, finite_want)
    assert finite_want.sum() > 0, "degenerate: no feasible candidates"
    np.testing.assert_allclose(got[finite_want], want[finite_want],
                               rtol=2e-4, atol=1e-2)
    # selection agreement
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_pallas_scoring_no_obstacles():
    cfg = _setup(with_obstacle=False)
    want = _xla_masked_costs(cfg)
    got, _ = _pallas_masked_costs(cfg)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_pallas_scoring_stopping_mode():
    """Stopping mode: quintic longitudinal candidates toward stop positions
    with the desired_s cost term and goal-behind filtering."""
    cfg = _setup(v0=8.0, with_obstacle=False)
    stop_s = 48.0
    static_grid = grid_ops.make_static_grid(1, 0.4, cfg["n_steps"] * cfg["dt"],
                                            cfg["dt"], -3.0, 3.0, 4)
    x0_lon = jnp.asarray([40.0, 8.0, 0.0], jnp.float32)
    x0_lat = jnp.asarray([0.3, 0.0, 0.0], jnp.float32)
    cl, ca, tl, goal_valid = grid_ops.stopping_candidates(
        x0_lon, x0_lat, jnp.float32(stop_s - 1.0), jnp.float32(stop_s + 1.0),
        jnp.asarray(False), static_grid)

    rollout = kin_ops.rollout(cl, ca, tl, cfg["ref"], cfg["veh"],
                              cfg["x0_theta"], cfg["dt"], cfg["n_steps"], False)
    want_costs = cost_ops.default_cost(
        rollout, w_a=jnp.float32(1.0), desired_d=jnp.float32(0.0),
        desired_speed=jnp.float32(0.0), desired_s=jnp.float32(stop_s))
    want = np.where(np.asarray(rollout.feasible & goal_valid),
                    np.asarray(want_costs), np.inf)

    got = np.asarray(_score(
        cfg, cl, ca, tl, goal_valid,
        _cost_params(0.0, w_a=1.0, desired_s=stop_s),
        ("default", True, True))[0])

    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    assert finite.sum() > 0
    np.testing.assert_allclose(got[finite], want[finite], rtol=2e-4, atol=1e-2)
    assert int(np.argmin(got)) == int(np.argmin(want))

def test_fleet_scoring_matches_per_problem():
    """score_fleet (the scorer vmapped over problems) must reproduce
    per-problem score_candidates for a heterogeneous fleet: different
    reference paths (sentinel-padded to a common length), obstacles,
    speeds, and a low-velocity member."""
    fleet_cfgs = [
        _setup(v0=15.0, low_vel=False, with_obstacle=True),
        _setup(v0=2.5, low_vel=True, with_obstacle=True),
        _setup(v0=10.0, low_vel=False, with_obstacle=False),
    ]
    # vary the geometry of problem 2 (different ref path + corridor width)
    xs = np.linspace(0.0, 180.0, 380)
    ys = 0.02 * xs + 3.0 * np.cos(xs / 45.0)
    ref2 = frenet_ops.from_polyline(np.stack([xs, ys], axis=1),
                                    dtype=jnp.float32)
    fleet_cfgs[2]["ref"] = ref2
    fleet_cfgs[2]["corridor"] = collision_ops.CorridorArrays(
        d_lo=jnp.full(ref2.s.shape[0], -3.2, jnp.float32),
        d_hi=jnp.full(ref2.s.shape[0], 3.2, jnp.float32))

    F = len(fleet_cfgs)
    n_steps = fleet_cfgs[0]["n_steps"]
    T = n_steps + 1
    K = fleet_cfgs[0]["cl"].shape[0]
    P = max(c["ref"].s.shape[0] for c in fleet_cfgs)

    def pad_ref(ref):
        n = P - ref.s.shape[0]
        rep = lambda a: jnp.concatenate([a, jnp.repeat(a[-1:], n, axis=0)])
        out = jax.tree.map(rep, ref)
        return out._replace(s=jnp.concatenate(
            [ref.s, ref.s[-1] + 1e6 * jnp.arange(1, n + 1, dtype=jnp.float32)]))

    def pad_band(band):
        return jnp.concatenate([band, jnp.full(P - band.shape[0], 1e4,
                                               jnp.float32)])

    want = [np.stack([np.asarray(row) for row in _score(
        c, c["cl"], c["ca"], c["tl"], jnp.ones(K, dtype=bool),
        _cost_params(c["desired_v"]), ("default", True, False))])
        for c in fleet_cfgs]                                   # [3, K] each

    M = max(c["obstacles"].pose.shape[0] for c in fleet_cfgs)
    obs_pose = np.zeros((F, M, T, 3), np.float32)
    obs_ext = np.ones((F, M, 2), np.float32)
    obs_valid = np.zeros((F, M, T), bool)
    for f, c in enumerate(fleet_cfgs):
        m = c["obstacles"].pose.shape[0]
        if m:
            obs_pose[f, :m] = np.asarray(c["obstacles"].pose)
            obs_ext[f, :m] = np.asarray(c["obstacles"].half_ext)
            obs_valid[f, :m] = np.asarray(c["obstacles"].valid)
    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)

    got = np.stack([np.asarray(row) for row in cycle_ops.score_fleet(
        jnp.stack([c["cl"] for c in fleet_cfgs]),
        jnp.stack([c["ca"] for c in fleet_cfgs]),
        jnp.stack([c["tl"] for c in fleet_cfgs]),
        jnp.ones((F, K), dtype=bool),
        stack([pad_ref(c["ref"]) for c in fleet_cfgs]),
        stack([c["veh"] for c in fleet_cfgs]),
        collision_ops.ObstacleArrays(pose=jnp.asarray(obs_pose),
                                     half_ext=jnp.asarray(obs_ext),
                                     valid=jnp.asarray(obs_valid)),
        collision_ops.CorridorArrays(
            d_lo=jnp.stack([-pad_band(-c["corridor"].d_lo)
                            for c in fleet_cfgs]),
            d_hi=jnp.stack([pad_band(c["corridor"].d_hi)
                            for c in fleet_cfgs])),
        jnp.stack([c["x0_theta"] for c in fleet_cfgs]),
        stack([_cost_params(c["desired_v"]) for c in fleet_cfgs]),
        jnp.asarray([c["low_vel"] for c in fleet_cfgs]),
        jnp.stack([c["ref"].s[-1] for c in fleet_cfgs]),
        dt=fleet_cfgs[0]["dt"], n_steps=n_steps,
        cost_structure=("default", True, False),
        constraint_flags=(True,) * 5)], axis=1)               # [F, 3, K]

    for f in range(F):
        np.testing.assert_array_equal(np.isfinite(got[f]),
                                      np.isfinite(want[f]),
                                      err_msg=f"problem {f} feasibility")
        np.testing.assert_array_equal(got[f][2], want[f][2],
                                      err_msg=f"problem {f} reasons")
        fin = np.isfinite(want[f][:2])
        assert fin[0].sum() > 0
        np.testing.assert_allclose(got[f][:2][fin], want[f][:2][fin],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"problem {f} costs")
