"""CommonRoad scenario XML writer (2020a format).

Completes the scenario-IO round trip (SURVEY.md section 2.2: commonroad-io is
the reference ecosystem's scenario reader/writer): serializes the object model
of utils.scenario back to CommonRoad XML, so modified or synthesized scenarios
(e.g. with the ego re-inserted as a dynamic obstacle via
convert_state_list_to_commonroad_object) can be persisted and re-read.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from commonroad_rp_jax.utils.scenario import (Circle, Interval, Polygon,
                                              PlanningProblemSet, Rectangle,
                                              Scenario)


def _point(parent: ET.Element, tag: str, xy) -> ET.Element:
    node = ET.SubElement(parent, tag)
    x = ET.SubElement(node, "x")
    x.text = f"{float(xy[0]):.6f}"
    y = ET.SubElement(node, "y")
    y.text = f"{float(xy[1]):.6f}"
    return node


def _value(parent: ET.Element, tag: str, value) -> None:
    if value is None:
        return
    node = ET.SubElement(parent, tag)
    if isinstance(value, Interval):
        lo = ET.SubElement(node, "intervalStart")
        lo.text = f"{value.start:.6f}"
        hi = ET.SubElement(node, "intervalEnd")
        hi.text = f"{value.end:.6f}"
    else:
        exact = ET.SubElement(node, "exact")
        exact.text = f"{float(value):.6f}"


def _shape(parent: ET.Element, shape) -> None:
    node = ET.SubElement(parent, "shape")
    _shape_body(node, shape)


def _shape_body(node: ET.Element, shape) -> None:
    if isinstance(shape, Rectangle):
        rect = ET.SubElement(node, "rectangle")
        for tag, value in (("length", shape.length), ("width", shape.width)):
            child = ET.SubElement(rect, tag)
            child.text = f"{value:.6f}"
        if shape.orientation:
            child = ET.SubElement(rect, "orientation")
            child.text = f"{shape.orientation:.6f}"
        if np.any(shape.center):
            _point(rect, "center", shape.center)
    elif isinstance(shape, Circle):
        circ = ET.SubElement(node, "circle")
        child = ET.SubElement(circ, "radius")
        child.text = f"{shape.radius:.6f}"
        if np.any(shape.center):
            _point(circ, "center", shape.center)
    elif isinstance(shape, Polygon):
        poly = ET.SubElement(node, "polygon")
        for vertex in shape.points:
            _point(poly, "point", vertex)
    else:
        raise ValueError(f"unsupported shape {type(shape)}")


def _state(parent: ET.Element, tag: str, state) -> None:
    node = ET.SubElement(parent, tag)
    if state.position is not None:
        pos = ET.SubElement(node, "position")
        _point(pos, "point", state.position)
    _value(node, "orientation", state.orientation)
    _value(node, "time", state.time_step)
    _value(node, "velocity", state.velocity)
    _value(node, "acceleration", state.acceleration)
    _value(node, "yawRate", state.yaw_rate)
    _value(node, "slipAngle", state.slip_angle)


def scenario_to_xml(scenario: Scenario,
                    planning_problem_set: Optional[PlanningProblemSet] = None
                    ) -> ET.Element:
    root = ET.Element("commonRoad")
    root.set("timeStepSize", f"{scenario.dt:g}")
    root.set("commonRoadVersion", "2020a")
    root.set("benchmarkID", scenario.scenario_id)

    for lanelet in scenario.lanelet_network.lanelets:
        node = ET.SubElement(root, "lanelet")
        node.set("id", str(lanelet.lanelet_id))
        for side, pts in (("leftBound", lanelet.left_vertices),
                          ("rightBound", lanelet.right_vertices)):
            bound = ET.SubElement(node, side)
            for vertex in pts:
                _point(bound, "point", vertex)
        for ref in lanelet.predecessors:
            ET.SubElement(node, "predecessor").set("ref", str(ref))
        for ref in lanelet.successors:
            ET.SubElement(node, "successor").set("ref", str(ref))
        if lanelet.adj_left is not None:
            adj = ET.SubElement(node, "adjacentLeft")
            adj.set("ref", str(lanelet.adj_left))
            adj.set("drivingDir",
                    "same" if lanelet.adj_left_same_direction else "opposite")
        if lanelet.adj_right is not None:
            adj = ET.SubElement(node, "adjacentRight")
            adj.set("ref", str(lanelet.adj_right))
            adj.set("drivingDir",
                    "same" if lanelet.adj_right_same_direction else "opposite")
        if lanelet.speed_limit is not None:
            child = ET.SubElement(node, "speedLimit")
            child.text = f"{lanelet.speed_limit:.6f}"

    for obstacle in scenario.static_obstacles:
        node = ET.SubElement(root, "staticObstacle")
        node.set("id", str(obstacle.obstacle_id))
        child = ET.SubElement(node, "type")
        child.text = obstacle.obstacle_type
        _shape(node, obstacle.shape)
        _state(node, "initialState", obstacle.initial_state)

    for obstacle in scenario.dynamic_obstacles:
        node = ET.SubElement(root, "dynamicObstacle")
        node.set("id", str(obstacle.obstacle_id))
        child = ET.SubElement(node, "type")
        child.text = obstacle.obstacle_type
        _shape(node, obstacle.shape)
        _state(node, "initialState", obstacle.initial_state)
        if obstacle.trajectory:
            traj = ET.SubElement(node, "trajectory")
            for state in obstacle.trajectory:
                _state(traj, "state", state)

    if planning_problem_set is not None:
        for pp in planning_problem_set.planning_problem_dict.values():
            node = ET.SubElement(root, "planningProblem")
            node.set("id", str(pp.planning_problem_id))
            _state(node, "initialState", pp.initial_state)
            for goal_state in pp.goal.state_list:
                gs_node = ET.SubElement(node, "goalState")
                if goal_state.position_shapes or goal_state.position_lanelets:
                    pos = ET.SubElement(gs_node, "position")
                    for lanelet_id in goal_state.position_lanelets:
                        ET.SubElement(pos, "lanelet").set("ref", str(lanelet_id))
                    for shape in goal_state.position_shapes:
                        _shape_body(pos, shape)
                _value(gs_node, "orientation", goal_state.orientation)
                _value(gs_node, "time", goal_state.time_step)
                _value(gs_node, "velocity", goal_state.velocity)
    return root


def write_scenario_xml(scenario: Scenario, path: str,
                       planning_problem_set: Optional[PlanningProblemSet] = None):
    tree = ET.ElementTree(scenario_to_xml(scenario, planning_problem_set))
    ET.indent(tree)
    tree.write(path, encoding="utf-8", xml_declaration=True)
