"""Evaluation harness: KS dynamics, input reconstruction, validity check."""

import numpy as np

from commonroad_rp_jax.models.state import InputState, TraceState
from commonroad_rp_jax.utils import evaluation as ev


def test_ks_straight_line():
    dyn = ev.VehicleDynamicsKS.from_vehicle_type(2)
    x0 = np.array([0.0, 0.0, 0.0, 10.0, 0.0])
    x1 = dyn.forward_simulation(x0, np.array([0.0, 0.0]), 0.1)
    np.testing.assert_allclose(x1, [1.0, 0.0, 0.0, 10.0, 0.0], atol=1e-9)


def test_ks_constant_acceleration():
    dyn = ev.VehicleDynamicsKS.from_vehicle_type(2)
    x0 = np.array([0.0, 0.0, 0.0, 5.0, 0.0])
    x1 = dyn.forward_simulation(x0, np.array([0.0, 2.0]), 0.5)
    np.testing.assert_allclose(x1[3], 6.0, atol=1e-9)          # v = v0 + a t
    np.testing.assert_allclose(x1[0], 5.0 * 0.5 + 0.5 * 2 * 0.25, atol=1e-6)


def test_ks_turning_radius():
    """Steady-state turn: yaw rate = v/L * tan(delta)."""
    dyn = ev.VehicleDynamicsKS.from_vehicle_type(2)
    delta = 0.1
    v = 8.0
    x = np.array([0.0, 0.0, delta, v, 0.0])
    t_total, n = 1.0, 10
    for _ in range(n):
        x = dyn.forward_simulation(x, np.array([0.0, 0.0]), t_total / n)
    expected_psi = v / dyn.params.wheelbase * np.tan(delta) * t_total
    np.testing.assert_allclose(x[4], expected_psi, rtol=1e-6)


def test_input_saturation():
    """Acceleration above the switched bound is clipped."""
    dyn = ev.VehicleDynamicsKS.from_vehicle_type(2)
    p = dyn.params
    v0 = p.v_switch + 5.0
    x0 = np.array([0.0, 0.0, 0.0, v0, 0.0])
    x1 = dyn.forward_simulation(x0, np.array([0.0, 100.0]), 0.1)
    assert x1[3] - v0 < p.a_max * 0.1 + 1e-9


def test_reconstruction_roundtrip():
    """Inputs applied through the model are recovered by the reconstruction."""
    dyn = ev.VehicleDynamicsKS.from_vehicle_type(2)
    x0_arr = np.array([2.0, 1.0, 0.05, 12.0, 0.2])
    u_true = np.array([0.15, 1.2])
    x1_arr = dyn.forward_simulation(x0_arr, u_true, 0.1)

    x0 = dyn.array_to_state(x0_arr, 0)
    x1 = dyn.array_to_state(x1_arr, 1)
    feasible, inp = ev.state_transition_feasibility(x0, x1, dyn, 0.1)
    assert feasible
    np.testing.assert_allclose(inp.acceleration, u_true[1], atol=0.2)


def test_check_acceleration_consistency():
    class Cfg:
        class planning:
            dt = 0.1

    # constant acceleration 1 m/s^2
    states = [TraceState(time_step=i, velocity=5.0 + 0.1 * i, acceleration=1.0)
              for i in range(10)]
    assert ev.check_acceleration(Cfg, states)


def test_solution_xml_roundtrip(tmp_path):
    """Solution -> XML file -> Solution preserves trajectory states."""
    import numpy as np

    from commonroad_rp_jax.models.state import ReactivePlannerState
    from commonroad_rp_jax.models.trajectories import Trajectory
    from commonroad_rp_jax.utils import solution_writer as sw
    from commonroad_rp_jax.utils.evaluation import (PlanningProblemSolution,
                                                    Solution)

    states = [ReactivePlannerState(
        time_step=i, position=np.array([1.0 * i, 0.5 * i]),
        steering_angle=0.01 * i, velocity=10.0 + i, orientation=0.1 * i)
        for i in range(5)]
    solution = Solution("ZAM_Over-1_1", [PlanningProblemSolution(
        planning_problem_id=1, vehicle_type=2, vehicle_model="KS",
        cost_function="JB1", trajectory=Trajectory(0, states))])

    path = str(tmp_path / "solution.xml")
    sw.write_solution_file(solution, path, computation_time=1.23)
    back = sw.read_solution_file(path)

    assert back.scenario_id == "ZAM_Over-1_1"
    pps = back.planning_problem_solutions[0]
    assert pps.vehicle_model == "KS" and pps.vehicle_type == 2
    assert len(pps.trajectory.state_list) == 5
    for a, b in zip(states, pps.trajectory.state_list):
        np.testing.assert_allclose(a.position, b.position, atol=1e-9)
        assert a.time_step == b.time_step
