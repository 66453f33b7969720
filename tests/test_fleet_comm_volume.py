"""Pin the fleet scan's per-cycle cross-device communication volume.

The weak-scaling argument (doc/scaling.md) rests on the claim that the
sharded replanning scan's ONLY cross-device traffic is a fixed handful of
scalar psums per cycle (success count, cost sum, finite count) — bytes over
the interconnect regardless of fleet size or candidate count.  This test inspects the
lowered StableHLO of the shard_map'd scan and asserts exactly that: three
``all_reduce`` ops, all reducing rank-0 scalars, and no other collective of
any kind (no all_gather / all_to_all / collective_permute / reduce_scatter
— nothing proportional to K or F crosses a device boundary).
"""

import importlib.util
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from commonroad_rp_jax.ops import grid as grid_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.parallel import fleet as fleet_ops
from commonroad_rp_jax.parallel.mesh import make_fleet_mesh
from commonroad_rp_jax.utils.config import VehicleConfiguration

_FORBIDDEN = ("all_gather", "all_to_all", "collective_permute",
              "reduce_scatter", "collective_broadcast")


@pytest.fixture(scope="module")
def lowered_text(repo_root):
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", repo_root / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)

    n_steps, dt = 20, 0.1
    problem = graft._build_problem(jnp.float32, n_steps)
    scene, carry = fleet_ops.build_fleet_scene([problem] * 8, n_steps,
                                               dtype=jnp.float32)
    v = VehicleConfiguration()
    veh = kin_ops.VehicleArrays(*[np.float32(x) for x in [
        v.wheelbase, v.wb_rear_axle, v.a_max, v.v_switch,
        np.tan(v.delta_max) / v.wheelbase, v.v_delta_max,
        v.length / 2, v.width / 2]])
    grid = grid_ops.make_static_grid(1, 0.4, 2.0, dt, -3.0, 3.0, 4)
    run = fleet_ops.make_fleet_rollout(
        make_fleet_mesh(8), veh, grid, dt, n_steps, replan_offset=3,
        low_vel_threshold=4.0, horizon=2.0, n_cycles=3)
    return jax.jit(run).lower(carry, scene).as_text()


def test_only_scalar_all_reduces(lowered_text):
    """Per cycle the scan communicates exactly three scalar all_reduces
    (n_success, cost_sum, n_finite psums, parallel/fleet.py:189-193) —
    <= 24 bytes between devices per cycle, independent of F and K."""
    occurrences = [m.start() for m in
                   re.finditer(r"stablehlo\.all_reduce", lowered_text)]
    assert len(occurrences) == 3, \
        f"expected 3 scalar psums, found {len(occurrences)} all_reduce ops"
    # each all_reduce's reduction block must bind rank-0 scalars: the op
    # region header ^bb0(%argN: tensor<T>, ...) appears right after the op
    for start in occurrences:
        window = lowered_text[start:start + 600]
        m = re.search(r"\^bb0\(%arg\d+: tensor<([^>]*)>", window)
        assert m is not None, window[:200]
        elem = m.group(1)
        assert re.fullmatch(r"(f32|f64|i32|i64|ui32|ui64)", elem), \
            f"non-scalar all_reduce operand: tensor<{elem}>"


def test_no_bulk_collectives(lowered_text):
    """Nothing proportional to fleet size or candidate count crosses a
    device boundary: no gather/scatter/permute collectives at all."""
    for name in _FORBIDDEN:
        assert f"stablehlo.{name}" not in lowered_text, \
            f"unexpected collective {name} in the fleet scan"


def test_pallas_fleet_scan_comm_volume(repo_root):
    """Same pin for the production fused-scorer fleet scan under a mesh: three
    scalar psums per cycle (parallel/pallas_fleet.py:268-271), nothing
    bulk."""
    import importlib.util

    from commonroad_rp_jax.parallel import pallas_fleet

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", repo_root / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    n_steps, dt = 20, 0.1
    problem = graft._build_problem(jnp.float32, n_steps)
    scene, carry = fleet_ops.build_fleet_scene([problem] * 8, n_steps,
                                               dtype=jnp.float32)
    grid = grid_ops.make_static_grid(1, 0.4, 2.0, dt, -3.0, 3.0, 4)
    run = pallas_fleet.make_pallas_fleet_scan(
        scene, grid, dt, n_steps, replan_offset=3, low_vel_threshold=4.0,
        horizon=2.0, n_cycles=2, mesh=make_fleet_mesh(8))
    with jax.enable_x64(False):
        text = jax.jit(lambda c: run(c)).lower(carry).as_text()
    n_reduce = len(re.findall(r"stablehlo\.all_reduce", text))
    assert n_reduce == 3, f"expected 3 scalar psums, found {n_reduce}"
    for name in _FORBIDDEN:
        assert f"stablehlo.{name}" not in text, name
