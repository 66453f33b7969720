"""Typed configuration system: YAML -> nested dataclasses.

Equivalent of the reference's OmegaConf-based config
(reference: commonroad_rp/utility/config.py:43-290) with identical field names
and defaults, so the reference's per-scenario YAML files load unchanged.
The files are read by :func:`load_yaml_subset` — the block-mapping subset
those files use — so loading a configuration needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np

from commonroad_rp_jax.utils.vehicle_params import VehicleParameters, vehicle_parameters


def _parse_scalar(text: str):
    """One YAML scalar: null, bool, int, float, quoted or plain string, or a
    flow list ``[a, b]`` of scalars."""
    if text in ("~", "null", "Null", "NULL"):
        return None
    if text.lower() in ("true", "yes", "on"):
        return True
    if text.lower() in ("false", "no", "off"):
        return False
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_parse_scalar(t.strip()) for t in inner.split(",")] \
            if inner else []
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (a ``#`` inside quotes is kept)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_yaml_subset(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the configuration files: nested block
    mappings by indentation, ``key: scalar`` entries (see
    :func:`_parse_scalar`) and comments.  Anything else (sequences in
    block form, anchors, multi-line scalars) raises ``ValueError``.
    """
    root: Dict[str, Any] = {}
    # (indent of the key line, mapping, indent of its entries once seen)
    stack = [[-1, root, None]]
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        key, sep, rest = body.partition(":")
        key, value = key.strip(), rest.strip()
        if (body[0] in "\t-&*|>?" or not sep or not key
                or (value and (not rest[0].isspace()
                               or value[0] in "&*|>!{"))):
            raise ValueError(f"line {lineno}: unsupported YAML: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        top = stack[-1]
        if top[2] is None:
            top[2] = indent
        elif indent != top[2]:
            raise ValueError(f"line {lineno}: inconsistent indentation")
        parent = top[1]
        if key in parent:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        if value:
            parent[key] = _parse_scalar(value)
        else:
            parent[key] = child = {}
            stack.append([indent, child, None])

    def empty_to_none(mapping):
        for key, value in mapping.items():
            if isinstance(value, dict):
                mapping[key] = empty_to_none(value) if value else None
        return mapping

    return empty_to_none(root)


def _fill_dataclass(cls, data: Dict[str, Any]):
    """Recursively build a dataclass from a (possibly partial) dict.

    Unknown keys raise; missing keys keep dataclass defaults.  Plays the role
    of the reference's _dict_to_params + OmegaConf merge validation
    (config.py:22-40, :98-101).
    """
    import typing
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in (data or {}).items():
        if key not in field_names:
            raise KeyError(f"Unknown config key '{key}' for {cls.__name__}")
        sub_cls = hints.get(key)
        if isinstance(value, dict) and isinstance(sub_cls, type) \
                and dataclasses.is_dataclass(sub_cls):
            kwargs[key] = _fill_dataclass(sub_cls, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


@dataclass
class PlanningConfiguration:
    """Planning parameters (reference: config.py:107-130)."""

    dt: float = 0.1
    time_steps_computation: int = 60
    planning_horizon: float = 6.0
    replanning_frequency: int = 3
    continuous_collision_check: bool = False
    factor: int = 1
    low_vel_mode_threshold: float = 4.0
    constraints_to_check: List[str] = field(
        default_factory=lambda: ["velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate"])
    standstill_lookahead: int = 10
    # extension: road-boundary check implementation
    # "corridor": drivable d-band gathers along the reference path (fast)
    # "segments": exact OBB-vs-boundary-segment SAT tests
    boundary_mode: str = "corridor"

    def __post_init__(self):
        self.planning_horizon = self.dt * self.time_steps_computation


@dataclass
class SamplingConfiguration:
    """Sampling parameters (reference: config.py:133-165)."""

    sampling_method: int = 1
    longitudinal_mode: str = "velocity_keeping"
    num_sampling_levels: int = 4
    t_min: float = 0.4
    v_min: float = 0.0
    v_max: float = 0.0
    s_min: float = -1.0
    s_max: float = 1.0
    d_min: float = -3.0
    d_max: float = 3.0


@dataclass
class DebugConfiguration:
    """Debug/observability parameters (reference: config.py:168-191).

    ``multiproc``/``num_workers`` are accepted for YAML compatibility; this
    build's parallelism is the candidate-axis batch on device, so they have no
    effect (SURVEY.md section 2.3).
    """

    save_plots: bool = False
    save_config: bool = False
    show_plots: bool = False
    draw_ref_path: bool = True
    draw_planning_problem: bool = True
    draw_icons: bool = False
    draw_traj_set: bool = False
    logging_level: str = "INFO"
    multiproc: bool = True
    num_workers: int = 6
    # extension: dtype of the device planning programs.  "auto" resolves at
    # planner construction (commonroad_rp_jax.backend.resolve_defaults):
    # float32 on a GPU backend (the production path), float64 on the CPU
    # (bit-level conformance with the float64 reference); any other
    # backend raises.  Set explicitly to pin either mode.
    kernel_dtype: str = "auto"
    # extension: score candidates with the fused scorer
    # (ops.cycle.score_candidates: three [K] rows, the winner re-rolled
    # alone, all sampling levels in one dispatch) instead of the dense
    # conformance program.  Rejection counters AND the per-constraint
    # reason dict stay exact (the scorer emits first-failure reason codes)
    # — better than the reference, which silently loses worker-side
    # statistics in multiprocessing mode (reactive_planner.py:962-967).
    # Applies with float32 programs and the default or fail-safe cost;
    # other settings use the conformance program.  None resolves at
    # planner construction: True on a GPU backend, False on the CPU.
    fast_scoring: Optional[bool] = None


@dataclass
class VehicleConfiguration:
    """Vehicle dimensions and constraint parameters (reference: config.py:194-222)."""

    id_type_vehicle: int = 2
    length: float = 0.0
    width: float = 0.0
    wb_front_axle: float = 0.0
    wb_rear_axle: float = 0.0
    a_max: float = 0.0
    v_switch: float = 0.0
    delta_min: float = 0.0
    delta_max: float = 0.0
    v_delta_min: float = 0.0
    v_delta_max: float = 0.0
    wheelbase: float = 0.0

    def __post_init__(self):
        params: VehicleParameters = vehicle_parameters(self.id_type_vehicle)
        # Any field left at its 0.0 sentinel is pulled from the vehicle DB,
        # mirroring the pull-from-vehicle-models defaults at config.py:203-219.
        self.length = self.length or params.l
        self.width = self.width or params.w
        self.wb_front_axle = self.wb_front_axle or params.a
        self.wb_rear_axle = self.wb_rear_axle or params.b
        self.a_max = self.a_max or params.a_max
        self.v_switch = self.v_switch or params.v_switch
        self.delta_min = self.delta_min or params.delta_min
        self.delta_max = self.delta_max or params.delta_max
        self.v_delta_min = self.v_delta_min or params.v_delta_min
        self.v_delta_max = self.v_delta_max or params.v_delta_max
        self.wheelbase = self.wheelbase or (params.a + params.b)
        # maximum curvature from max steering angle (config.py:222)
        self.kappa_max = np.tan(self.delta_max) / self.wheelbase


@dataclass
class GeneralConfiguration:
    """Paths (reference: config.py:225-243)."""

    path_scenarios: str = "example_scenarios/"
    path_output: str = "output/"
    path_logs: str = "output/logs/"
    path_pickles: str = "output/pickles/"
    path_scenario: Optional[str] = None
    name_scenario: Optional[str] = None

    def set_path_scenario(self, scenario_name: str):
        self.path_scenario = os.path.join(self.path_scenarios, scenario_name)
        self.name_scenario = scenario_name


@dataclass
class ReactivePlannerConfiguration:
    """Root configuration (reference: config.py:246-290)."""

    vehicle: VehicleConfiguration = field(default_factory=VehicleConfiguration)
    planning: PlanningConfiguration = field(default_factory=PlanningConfiguration)
    sampling: SamplingConfiguration = field(default_factory=SamplingConfiguration)
    debug: DebugConfiguration = field(default_factory=DebugConfiguration)
    general: GeneralConfiguration = field(default_factory=GeneralConfiguration)

    def __post_init__(self):
        self.scenario = None
        self.planning_problem = None
        self.planning_problem_set = None

    @property
    def name_scenario(self) -> Optional[str]:
        return self.general.name_scenario

    @classmethod
    def load(cls, file_path: Union[pathlib.Path, str],
             scenario_name: Optional[str] = None) -> "ReactivePlannerConfiguration":
        """Load a YAML config file (reference: config.py:84-104)."""
        file_path = pathlib.Path(file_path)
        assert file_path.suffix == ".yaml", \
            f"File type {file_path.suffix} is unsupported! Please use .yaml!"
        with open(file_path) as fh:
            loaded = load_yaml_subset(fh.read())
        config = _fill_dataclass(cls, loaded)
        if scenario_name:
            config.general.set_path_scenario(scenario_name)
        return config

    def update(self, scenario=None, planning_problem=None,
               idx_planning_problem: Optional[int] = None):
        """Attach (or load) scenario + planning problem (reference: config.py:265-290)."""
        from commonroad_rp_jax.utils.general import load_scenario_and_planning_problem

        self.scenario = scenario
        self.planning_problem = planning_problem
        if scenario is None and planning_problem is None:
            self.scenario, self.planning_problem, self.planning_problem_set = \
                load_scenario_and_planning_problem(self.general.path_scenario,
                                                   idx_planning_problem)
        assert self.scenario is not None, \
            "<Configuration.update()>: no scenario has been specified"
