"""Scenario-format edge cases: shape variants, shape groups, offsets."""

import textwrap

import numpy as np
import pytest

import jax.numpy as jnp

from commonroad_rp_jax.ops import collision as co
from commonroad_rp_jax.utils.scenario import read_scenario_xml


def _write_scenario(tmp_path, body: str) -> str:
    path = tmp_path / "synthetic.xml"
    path.write_text(textwrap.dedent(f"""\
        <?xml version="1.0" encoding="utf-8"?>
        <commonRoad timeStepSize="0.1" commonRoadVersion="2020a" benchmarkID="SYN-1">
          <lanelet id="1">
            <leftBound>
              <point><x>0</x><y>3</y></point>
              <point><x>100</x><y>3</y></point>
            </leftBound>
            <rightBound>
              <point><x>0</x><y>-3</y></point>
              <point><x>100</x><y>-3</y></point>
            </rightBound>
          </lanelet>
          {body}
        </commonRoad>
        """))
    return str(path)


def test_circle_and_polygon_obstacles(tmp_path):
    body = """
          <staticObstacle id="10">
            <type>unknown</type>
            <shape><circle><radius>2.5</radius></circle></shape>
            <initialState>
              <position><point><x>40</x><y>0</y></point></position>
              <orientation><exact>0</exact></orientation>
              <time><exact>0</exact></time>
            </initialState>
          </staticObstacle>
          <staticObstacle id="11">
            <type>unknown</type>
            <shape><polygon>
              <point><x>60</x><y>-1</y></point>
              <point><x>64</x><y>-1</y></point>
              <point><x>62</x><y>2</y></point>
            </polygon></shape>
            <initialState>
              <position><point><x>0</x><y>0</y></point></position>
              <orientation><exact>0</exact></orientation>
              <time><exact>0</exact></time>
            </initialState>
          </staticObstacle>
          <planningProblem id="1">
            <initialState>
              <position><point><x>5</x><y>0</y></point></position>
              <velocity><exact>10</exact></velocity>
              <orientation><exact>0</exact></orientation>
              <yawRate><exact>0</exact></yawRate>
              <slipAngle><exact>0</exact></slipAngle>
              <time><exact>0</exact></time>
            </initialState>
            <goalState>
              <position><rectangle><length>10</length><width>4</width>
                <center><x>90</x><y>0</y></center></rectangle></position>
              <time><intervalStart>0</intervalStart><intervalEnd>100</intervalEnd></time>
            </goalState>
          </planningProblem>
    """
    scenario, pp_set = read_scenario_xml(_write_scenario(tmp_path, body))
    assert len(scenario.static_obstacles) == 2
    circle, polygon = scenario.static_obstacles
    assert circle.shape.radius == 2.5
    assert polygon.shape.points.shape == (3, 2)

    obstacles = co.compile_obstacles(scenario, 0, 5)
    # circle -> exact disc row: zero half extents + radius
    half = np.asarray(obstacles.half_ext)
    np.testing.assert_allclose(half[0], [0.0, 0.0])
    np.testing.assert_allclose(np.asarray(obstacles.radius)[0], 2.5)
    # polygon -> exact convex piece in the polygon group (one piece, 3 verts)
    assert obstacles.poly_verts is not None
    assert obstacles.poly_verts.shape[0] == 1
    assert obstacles.poly_verts.shape[2] == 3
    assert bool(np.all(np.asarray(obstacles.poly_valid)))


def test_goal_shape_group(tmp_path):
    body = """
          <planningProblem id="1">
            <initialState>
              <position><point><x>5</x><y>0</y></point></position>
              <velocity><exact>10</exact></velocity>
              <orientation><exact>0</exact></orientation>
              <time><exact>0</exact></time>
            </initialState>
            <goalState>
              <position>
                <rectangle><length>4</length><width>4</width>
                  <center><x>50</x><y>0</y></center></rectangle>
                <rectangle><length>4</length><width>4</width>
                  <center><x>90</x><y>0</y></center></rectangle>
              </position>
              <time><intervalStart>0</intervalStart><intervalEnd>100</intervalEnd></time>
            </goalState>
          </planningProblem>
    """
    _, pp_set = read_scenario_xml(_write_scenario(tmp_path, body))
    goal = list(pp_set.planning_problem_dict.values())[0].goal
    assert len(goal.state_list[0].position_shapes) == 2

    from commonroad_rp_jax.models.state import TraceState
    in_second = TraceState(time_step=10, position=np.array([90.0, 0.0]),
                           velocity=5.0)
    assert goal.is_reached(in_second)


def test_rotated_rectangle_obstacle_offsets(tmp_path):
    """Shape-level orientation/center offsets compose with the state pose."""
    body = """
          <staticObstacle id="20">
            <type>unknown</type>
            <shape><rectangle>
              <length>10</length><width>1</width>
              <orientation>1.5707963</orientation>
              <center><x>2</x><y>0</y></center>
            </rectangle></shape>
            <initialState>
              <position><point><x>40</x><y>0</y></point></position>
              <orientation><exact>0</exact></orientation>
              <time><exact>0</exact></time>
            </initialState>
          </staticObstacle>
          <planningProblem id="1">
            <initialState>
              <position><point><x>5</x><y>0</y></point></position>
              <velocity><exact>10</exact></velocity>
              <orientation><exact>0</exact></orientation>
              <time><exact>0</exact></time>
            </initialState>
            <goalState>
              <position><rectangle><length>4</length><width>4</width>
                <center><x>90</x><y>0</y></center></rectangle></position>
              <time><intervalStart>0</intervalStart><intervalEnd>100</intervalEnd></time>
            </goalState>
          </planningProblem>
    """
    scenario, _ = read_scenario_xml(_write_scenario(tmp_path, body))
    obstacles = co.compile_obstacles(scenario, 0, 3)
    pose = np.asarray(obstacles.pose)[0, 0]
    np.testing.assert_allclose(pose[:2], [42.0, 0.0])      # body-frame offset
    np.testing.assert_allclose(pose[2], 1.5707963)         # composed rotation

    # the rotated 10m-long bar spans y in [-5, 5] at x ~ 42: an ego pose at
    # (42, 4) must collide; without the orientation it would not
    hit = co.check_collisions(
        jnp.asarray([[42.0]]), jnp.asarray([[4.0]]), jnp.asarray([[0.0]]),
        obstacles, None, jnp.asarray(2.25), jnp.asarray(0.8), jnp.asarray(0.0))
    assert bool(hit[0])


def test_reference_yaml_configs_load_verbatim():
    """The reference repo's own per-scenario YAML files must load unchanged
    (drop-in config compatibility)."""
    import pathlib

    from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration

    ref_dir = pathlib.Path("/root/reference/configurations")
    if not ref_dir.exists():
        pytest.skip("reference configurations not mounted")
    for yaml_path in sorted(ref_dir.glob("*.yaml")):
        config = ReactivePlannerConfiguration.load(yaml_path)
        assert config.planning.dt == 0.1
        assert config.planning.time_steps_computation == 20
        assert config.vehicle.id_type_vehicle == 2
        assert config.vehicle.wheelbase > 2.0      # pulled from the vehicle DB


@pytest.mark.parametrize("name", ["ZAM_Over-1_1", "DEU_Test-1_1_T-1",
                                  "ZAM_Tjunction-1_42_T-1"])
def test_scenario_writer_roundtrip(tmp_path, name):
    """read -> write -> read preserves the scene and planning problem."""
    import pathlib

    from commonroad_rp_jax.utils.scenario_writer import write_scenario_xml

    src = pathlib.Path(__file__).parent.parent / "example_scenarios" / f"{name}.xml"
    scenario, pps = read_scenario_xml(str(src))
    out = str(tmp_path / "roundtrip.xml")
    write_scenario_xml(scenario, out, pps)
    back, back_pps = read_scenario_xml(out)

    assert back.scenario_id == scenario.scenario_id
    assert back.dt == scenario.dt
    assert len(back.lanelet_network.lanelets) == len(scenario.lanelet_network.lanelets)
    assert len(back.static_obstacles) == len(scenario.static_obstacles)
    assert len(back.dynamic_obstacles) == len(scenario.dynamic_obstacles)
    for a, b in zip(scenario.lanelet_network.lanelets,
                    back.lanelet_network.lanelets):
        np.testing.assert_allclose(a.left_vertices, b.left_vertices, atol=1e-5)
        assert a.successors == b.successors
        assert a.adj_left == b.adj_left
    for a, b in zip(scenario.dynamic_obstacles, back.dynamic_obstacles):
        assert len(a.trajectory) == len(b.trajectory)
        s_a = a.state_at_time(5)
        s_b = b.state_at_time(5)
        if s_a is not None:
            np.testing.assert_allclose(s_a.position, s_b.position, atol=1e-5)
    pp_a = list(pps.planning_problem_dict.values())[0]
    pp_b = list(back_pps.planning_problem_dict.values())[0]
    np.testing.assert_allclose(pp_a.initial_state.position,
                               pp_b.initial_state.position, atol=1e-5)
    assert len(pp_a.goal.state_list) == len(pp_b.goal.state_list)
    ga, gb = pp_a.goal.state_list[0], pp_b.goal.state_list[0]
    assert ga.position_lanelets == gb.position_lanelets
    assert len(ga.position_shapes) == len(gb.position_shapes)
