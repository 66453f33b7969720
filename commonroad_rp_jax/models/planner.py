"""ReactivePlanner facade: the reference-compatible planner API over the
batched device cycle kernel.

API mirror of the reference planner (reference:
commonroad_rp/reactive_planner.py:52-1159).  Host responsibilities are scene
compilation, grid generation, the sampling-level escalation loop, and output
assembly; everything per-candidate happens in the single jitted program
``ops.cycle.evaluate_level``.  There is no multiprocessing fan-out
(reference :1084-1111) — the candidate axis is vectorized on device
(SURVEY.md section 2.3).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from commonroad_rp_jax.models.cost_functions import (CostFunction,
                                                     DefaultCostFunction)
from commonroad_rp_jax.models.sampling import (CandidateBatch,
                                               CorridorSampling,
                                               PositionSampling, SamplingSpace,
                                               TimeSampling, VelocitySampling,
                                               sampling_space_factory)
from commonroad_rp_jax.models.state import InputState, ReactivePlannerState
from commonroad_rp_jax.models.trajectories import (BundleSummary,
                                                   OptimalTrajectory,
                                                   Trajectory)
from commonroad_rp_jax.models.state import TraceState
from commonroad_rp_jax.ops import collision as collision_ops
from commonroad_rp_jax.ops import cycle as cycle_ops
from commonroad_rp_jax.ops import kinematics as kin_ops
from commonroad_rp_jax.utils.config import ReactivePlannerConfiguration
from commonroad_rp_jax.utils.coordinate_system import CoordinateSystem
from commonroad_rp_jax.utils.general import (retrieve_desired_velocity_from_pp,
                                             shift_orientation_states)
from commonroad_rp_jax.utils.geometry import interpolate_angle
from commonroad_rp_jax.utils.scenario import Scenario

logger = logging.getLogger("RP_LOGGER")

_EPS = 1e-5

_CONSTRAINT_ORDER = ("velocity", "acceleration", "kappa", "kappa_dot", "yaw_rate")


class CollisionChecker:
    """Compiled scene: road-boundary segments + obstacle source.

    Equivalent of the pycrcc.CollisionChecker built at
    reactive_planner.py:218-256; reused across cycles via reset()
    (run_planner.py:84-86).
    """

    def __init__(self, scenario: Scenario, continuous: bool, dtype):
        self.scenario = scenario
        self.continuous = continuous
        self.dtype = dtype
        self.boundary = collision_ops.compile_road_boundary(scenario, dtype=dtype)
        self._window_cache: Dict[Tuple[int, int, int], collision_ops.ObstacleArrays] = {}
        # weak keying: id() reuse after GC must not alias a new reference path
        # to a stale corridor
        import weakref
        self._corridor_cache = weakref.WeakKeyDictionary()

    def corridor_for(self, coordinate_system) -> collision_ops.CorridorArrays:
        """Drivable d-band tables for a reference path (cached per CoSys)."""
        if coordinate_system not in self._corridor_cache:
            self._corridor_cache[coordinate_system] = collision_ops.compile_corridor(
                self.boundary, coordinate_system.tables, dtype=self.dtype)
        return self._corridor_cache[coordinate_system]

    def obstacles_for_window(self, t_start: int, horizon_steps: int,
                             factor: int) -> collision_ops.ObstacleArrays:
        key = (t_start, horizon_steps, factor)
        if key not in self._window_cache:
            self._window_cache[key] = collision_ops.compile_obstacles(
                self.scenario, t_start, horizon_steps, factor, dtype=self.dtype)
        return self._window_cache[key]


class ReactivePlanner:
    """Sampling-based reactive trajectory planner (device-batched cycle)."""

    def __init__(self, config: ReactivePlannerConfiguration):
        # horizon variables (reactive_planner.py:63-65)
        self.dt: float = config.planning.dt
        self.N: int = config.planning.time_steps_computation
        self.horizon: float = config.planning.dt * config.planning.time_steps_computation

        self.vehicle_params = config.vehicle

        # backend-resolved defaults (utils/config.py DebugConfiguration)
        if config.debug.kernel_dtype == "auto" \
                or config.debug.fast_scoring is None:
            from commonroad_rp_jax.backend import resolve_defaults
            defaults = resolve_defaults()
            if config.debug.kernel_dtype == "auto":
                config.debug.kernel_dtype = defaults.kernel_dtype
            if config.debug.fast_scoring is None:
                config.debug.fast_scoring = defaults.fast_scoring
        self._dtype = jnp.float64 if config.debug.kernel_dtype == "float64" \
            else jnp.float32

        # planner initial states (cartesian + curvilinear)
        self.x_0: Optional[ReactivePlannerState] = None
        self.x_0_cl: Optional[Tuple[List, List]] = None

        self._co: Optional[CoordinateSystem] = None
        self._cc: Optional[CollisionChecker] = None

        # statistics (reactive_planner.py:79-88)
        self._infeasible_count_collision: int = 0
        self._infeasible_count_kinematics: int = 0
        self._infeasible_reason_dict: Dict[str, int] = {}
        self._optimal_cost: float = 0.0
        self._planning_times_list: List[float] = []
        from commonroad_rp_jax.utils.profiling import StageTimers
        self.stage_timers = StageTimers()
        self._record_state_list: List[ReactivePlannerState] = []
        self._record_input_list: List[InputState] = []
        self.stored_trajectories: Optional[BundleSummary] = None

        self._desired_speed: Optional[float] = None
        self._desired_lon_position: Optional[float] = None
        self._low_vel_mode = False

        self._draw_traj_set = config.debug.draw_traj_set and \
            (config.debug.show_plots or config.debug.save_plots)

        self.config: Optional[ReactivePlannerConfiguration] = None
        self.reset(config)

        self.sampling_space: Optional[SamplingSpace] = None
        self.set_sampling_space()
        self.sampling_level = config.sampling.num_sampling_levels

        self.cost_function: Optional[CostFunction] = None
        self.set_cost_function()

        self._standstill_lookahead = config.planning.standstill_lookahead

    # ------------------------------------------------------------------
    # properties (reactive_planner.py:115-160)
    # ------------------------------------------------------------------

    @property
    def collision_checker(self) -> CollisionChecker:
        return self._cc

    @property
    def coordinate_system(self) -> CoordinateSystem:
        return self._co

    @property
    def reference_path(self) -> np.ndarray:
        return self._co.reference

    @property
    def infeasible_count_collision(self) -> int:
        return self._infeasible_count_collision

    @property
    def infeasible_count_kinematics(self) -> int:
        return self._infeasible_count_kinematics

    @property
    def infeasible_reason_dict(self) -> dict:
        self._materialize_reason_stats()
        return self._infeasible_reason_dict

    @property
    def optimal_cost(self) -> float:
        return self._optimal_cost

    @property
    def planning_times(self) -> List[float]:
        return self._planning_times_list

    @property
    def record_state_list(self) -> List[ReactivePlannerState]:
        return self._record_state_list

    @property
    def record_input_list(self) -> List[InputState]:
        return self._record_input_list

    # ------------------------------------------------------------------
    # setup / reset
    # ------------------------------------------------------------------

    def goal_reached(self) -> bool:
        """Initial state within the goal region (reactive_planner.py:162-170)."""
        x_0_shifted = self.x_0.shift_positions_to_center(self.vehicle_params.wb_rear_axle)
        if self.config.planning_problem.goal.is_reached(x_0_shifted):
            logger.info("Goal of planning problem reached")
            return True
        return False

    def goal_center_s(self) -> Optional[float]:
        """Arclength of the goal region's center on the current reference
        path, or None when the goal has no position constraint.

        Composition helper for stop-at-goal missions: the reference's two
        longitudinal modes chained into one run (velocity-keeping to the
        goal, then ``set_desired_lon_position(goal_center_s())`` + stopping
        mode — reactive_planner.py:349-376 + run_planner.py:61-107).
        """
        assert self._co is not None, "set_reference_path first"
        goal = self.config.planning_problem.goal
        centers = []
        for gs in goal.state_list:
            for shape in gs.position_shapes:
                center = getattr(shape, "center", None)
                if center is None and hasattr(shape, "vertices"):
                    center = np.mean(np.asarray(shape.vertices), axis=0)
                if center is not None:
                    centers.append(np.asarray(center, dtype=float))
            for lanelet_id in gs.position_lanelets:
                lanelet = self.config.scenario.lanelet_network \
                    .find_lanelet_by_id(lanelet_id)
                if lanelet is not None:
                    cv = lanelet.center_vertices
                    centers.append(np.asarray(cv[len(cv) // 2], dtype=float))
        if not centers:
            return None
        center = np.mean(np.stack(centers), axis=0)
        s, _ = self._co.convert_to_curvilinear_coords(center[0], center[1])
        return float(s)

    def reset(self, config: ReactivePlannerConfiguration = None,
              initial_state_cart: ReactivePlannerState = None,
              initial_state_curv: Tuple[List, List] = None,
              collision_checker: CollisionChecker = None,
              coordinate_system: CoordinateSystem = None):
        """Re-initialize for replanning (reactive_planner.py:172-216)."""
        if config is not None:
            self.config = config
        else:
            assert self.config is not None, \
                "<ReactivePlanner.reset(). No Configuration object provided>"

        self._reset_statistics()

        if collision_checker is None:
            self.set_collision_checker(scenario=self.config.scenario)
        else:
            self.set_collision_checker(collision_checker=collision_checker)

        if coordinate_system is not None:
            self.set_reference_path(coordinate_system=coordinate_system)

        if self.x_0 is None and initial_state_cart is None:
            if self.config.planning_problem:
                self.x_0 = ReactivePlannerState.create_from_initial_state(
                    self.config.planning_problem.initial_state,
                    self.vehicle_params.wheelbase, self.vehicle_params.wb_rear_axle)
            else:
                self.x_0 = None
        else:
            self.x_0 = initial_state_cart if initial_state_cart is not None else self.x_0

        self.x_0_cl = initial_state_curv if initial_state_curv is not None \
            else self._compute_initial_states(self.x_0)

    def set_collision_checker(self, scenario: Scenario = None,
                              collision_checker: CollisionChecker = None):
        """Compile or adopt the scene (reactive_planner.py:218-256)."""
        if collision_checker is None:
            assert scenario is not None, \
                "<ReactivePlanner.set_collision_checker>: provide a scenario OR a checker"
            self._cc = CollisionChecker(
                scenario, self.config.planning.continuous_collision_check,
                self._dtype)
        else:
            assert scenario is None, \
                "<ReactivePlanner.set_collision_checker>: provide a scenario OR a checker"
            self._cc = collision_checker

    def set_reference_path(self, reference_path: np.ndarray = None,
                           coordinate_system: CoordinateSystem = None):
        """Build or adopt the curvilinear frame (reactive_planner.py:258-272)."""
        if coordinate_system is None:
            assert reference_path is not None, \
                "<set reference path>: provide a reference path OR a CoordinateSystem"
            self._co = CoordinateSystem(reference_path, dtype=self._dtype)
        else:
            assert reference_path is None, \
                "<set reference path>: provide a reference path OR a CoordinateSystem"
            self._co = coordinate_system

    # sampling-parameter setters (reactive_planner.py:274-307)

    def set_t_sampling_parameters(self, t_min):
        self.sampling_space.samples_t = TimeSampling(t_min, self.horizon,
                                                     self.sampling_level, self.dt)

    def set_d_sampling_parameters(self, delta_d_min, delta_d_max):
        self.sampling_space.samples_d = PositionSampling(delta_d_min, delta_d_max,
                                                         self.sampling_level)

    def set_v_sampling_parameters(self, v_min, v_max):
        self.sampling_space.samples_v = VelocitySampling(v_min, v_max,
                                                         self.sampling_level)

    def set_s_sampling_parameters(self, s_min, s_max):
        self.sampling_space.samples_s = PositionSampling(s_min, s_max,
                                                         self.sampling_level)

    def set_desired_velocity(self, desired_velocity: float = None,
                             current_speed: float = None, stopping: bool = False):
        """Velocity target + sampled interval (reactive_planner.py:309-347)."""
        self._desired_lon_position = None
        if desired_velocity is None and self._desired_speed is None:
            self._desired_speed = retrieve_desired_velocity_from_pp(
                self.config.planning_problem)
        else:
            self._desired_speed = desired_velocity if desired_velocity is not None \
                else self._desired_speed
        assert self._desired_speed >= 0.0, \
            f"<ReactivePlanner.set_desired_velocity(): desired speed has to be " \
            f"positive. Provided speed{self._desired_speed}>"

        if not stopping:
            reference_speed = current_speed if current_speed is not None \
                else self._desired_speed
            min_v = max(0, reference_speed - (0.125 * self.horizon *
                                              self.vehicle_params.a_max))
            max_v = max(min_v + 5.0, reference_speed + 2)
            self.set_v_sampling_parameters(min_v, max_v)
        else:
            self.set_v_sampling_parameters(self._desired_speed, self._desired_speed)

        if hasattr(self.cost_function, "desired_speed"):
            self.cost_function.desired_speed = self._desired_speed
        if hasattr(self.cost_function, "w_a"):
            self.cost_function.w_a = 5
        if hasattr(self.cost_function, "desired_s"):
            self.cost_function.desired_s = self._desired_lon_position

    def set_desired_lon_position(self, lon_position: float,
                                 delta_s_min: Optional[float] = None,
                                 delta_s_max: Optional[float] = None):
        """Stop-position target (reactive_planner.py:349-376)."""
        self._desired_lon_position = lon_position
        self._desired_speed = 0.0
        if delta_s_min is None and delta_s_max is None:
            delta_s_min = self.config.sampling.s_min
            delta_s_max = self.config.sampling.s_max
        self.set_s_sampling_parameters(lon_position + delta_s_min,
                                       lon_position + delta_s_max)
        if hasattr(self.cost_function, "desired_s"):
            self.cost_function.desired_s = self._desired_lon_position
        if hasattr(self.cost_function, "desired_speed"):
            self.cost_function.desired_speed = self._desired_speed
        if hasattr(self.cost_function, "w_a"):
            self.cost_function.w_a = 1

    def set_cost_function(self, cost_function: CostFunction = None):
        if cost_function:
            self.cost_function = cost_function
        else:
            self.cost_function = DefaultCostFunction(
                self._desired_speed, desired_d=0.0,
                desired_s=self._desired_lon_position)

    def set_sampling_space(self, sampling_space: SamplingSpace = None):
        if sampling_space:
            self.sampling_space = sampling_space
        else:
            self.sampling_space = sampling_space_factory(self.config)

    def record_state_and_input(self, state: ReactivePlannerState):
        """Append state + derived control input (reactive_planner.py:391-408)."""
        self._record_state_list.append(state)
        if len(self._record_state_list) > 1:
            steering_angle_speed = (state.steering_angle -
                                    self._record_state_list[-2].steering_angle) / self.dt
        else:
            steering_angle_speed = 0.0
        self._record_input_list.append(InputState(
            time_step=state.time_step, acceleration=state.acceleration,
            steering_angle_speed=steering_angle_speed))

    def _reset_statistics(self):
        """(reactive_planner.py:410-419)"""
        self._optimal_cost = 0
        self._infeasible_count_kinematics = 0
        self._infeasible_count_collision = 0
        self._pending_reason_stats = None
        for constraint in self.config.planning.constraints_to_check:
            self._infeasible_reason_dict[constraint] = 0

    def _materialize_reason_stats(self):
        """Deferred device->host readback of the per-constraint counters
        (each readback synchronises with the device; only pay when the
        statistics are actually consumed)."""
        pending = getattr(self, "_pending_reason_stats", None)
        if pending is None:
            return
        self._pending_reason_stats = None
        if pending[0] == "xla":
            _, masks_dev, goal_valid = pending
            masks = np.asarray(masks_dev)
            feasible = masks[0].astype(bool)
            reasons = masks[2]
        else:                                   # fast path: kernel reason row
            _, reasons_dev, kin_dev, goal_valid = pending
            import jax as _jax
            reasons, kin = _jax.device_get((reasons_dev, kin_dev))
            reasons = np.asarray(reasons)
            feasible = np.isfinite(np.asarray(kin))
        for code, name in kin_ops.REASON_NAMES.items():
            if name in self._infeasible_reason_dict:
                self._infeasible_reason_dict[name] += int(
                    np.sum((reasons == code) & goal_valid & ~feasible))

    def _create_trajectory_bundle(self, x_0_lon, x_0_lat,
                                  samp_level: int) -> CandidateBatch:
        """Sample the candidate bundle for one level (reactive_planner.py:421-444).

        Returns the dense CandidateBatch (the array-of-candidates replacement
        for the reference's TrajectoryBundle). No feasibility or collision
        checking happens here.
        """
        return self.sampling_space.generate_trajectories_at_level(
            samp_level, np.asarray(x_0_lon), np.asarray(x_0_lat),
            self.config.sampling.longitudinal_mode, self._low_vel_mode)

    # ------------------------------------------------------------------
    # initial-state transform (reactive_planner.py:446-512)
    # ------------------------------------------------------------------

    def _compute_initial_states(self, x_0: ReactivePlannerState):
        """Cartesian -> curvilinear initial state (Werling Eqs. A.3/A.5)."""
        if not self._co:
            return None
        try:
            return self._co.compute_initial_curvilinear_states(
                x_0.position, x_0.orientation, x_0.velocity, x_0.acceleration,
                x_0.steering_angle, self.vehicle_params.wheelbase,
                self._low_vel_mode)
        except ValueError:
            logger.critical("Initial state could not be transformed.")
            raise ValueError("Initial state could not be transformed.")

    # ------------------------------------------------------------------
    # planning cycle (reactive_planner.py:570-665)
    # ------------------------------------------------------------------

    def plan(self, current_sampling_level: int = None) -> Optional[tuple]:
        """Plan an optimal trajectory; returns
        (cartesian Trajectory, curvilinear Trajectory, lon list, lat list)."""
        planning_start_time = time.time()

        assert self.x_0 is not None, \
            "<ReactivePlanner.plan(): Planner Cartesian initial state is empty!>"
        assert self._co is not None, \
            "<ReactivePlanner.plan(): No coordinate system given. Call set_reference_path()>"
        if not self.x_0_cl:
            self.x_0_cl = self._compute_initial_states(self.x_0)
        assert self.x_0_cl is not None, \
            "<ReactivePlanner.plan(): Planner curvilinear initial state is empty!>"

        x_0_lon, x_0_lat = self.x_0_cl
        self._low_vel_mode = \
            self.x_0.velocity < self.config.planning.low_vel_mode_threshold

        logger.info("=== Starting Planning Cycle (time_step=%s, v=%.3f) ===",
                    self.x_0.time_step, self.x_0.velocity)

        optimal_trajectory: Optional[OptimalTrajectory] = None
        bundle_stats = None
        i = 1 if current_sampling_level is None else current_sampling_level

        # fused escalation (fast path): all levels in one device dispatch
        fused = None
        if current_sampling_level is None and self.config.debug.fast_scoring:
            fused = self._plan_all_levels_fast(x_0_lon, x_0_lat, i)
        if fused is not None:
            optimal_trajectory, bundle_stats = fused
        else:
            while optimal_trajectory is None and i < self.sampling_level:
                with self.stage_timers.stage("grid_generation"):
                    batch = self._create_trajectory_bundle(x_0_lon, x_0_lat, i)
                logger.info("Sampling level %d/%d: %d candidates", i + 1,
                            self.sampling_level, batch.size)
                optimal_trajectory, bundle_stats = \
                    self._get_optimal_trajectory(batch)
                logger.info("Rejected %d kinematically infeasible, %d colliding",
                            self._infeasible_count_kinematics,
                            self._infeasible_count_collision)
                if current_sampling_level is not None:
                    break
                i += 1

        # standstill fallback (reactive_planner.py:638-653)
        if ((optimal_trajectory is None or
             optimal_trajectory.cartesian.v[self._standstill_lookahead] <= 0.05)
                and self.x_0.velocity <= 0.05):
            logger.info("Planning standstill for the current scenario")
            optimal_trajectory = self._compute_standstill_trajectory()

        if optimal_trajectory is not None:
            self._optimal_cost = optimal_trajectory.cost
            if bundle_stats is not None and bundle_stats["cost_span"] > 0:
                logger.info("Found optimal trajectory with costs = %.3f (%.3f of "
                            "seen costs)", self._optimal_cost,
                            (self._optimal_cost - bundle_stats["cost_min"]) /
                            bundle_stats["cost_span"])

        planning_result = self._compute_trajectory_pair(optimal_trajectory) \
            if optimal_trajectory is not None else None

        self._planning_times_list.append(time.time() - planning_start_time)
        logger.info("Total planning time: %.7f", self._planning_times_list[-1])
        if planning_result is None:
            logger.warning("Planner failed to find an optimal trajectory "
                           "with given sampling configuration!")
        return planning_result

    def _scene_context(self):
        """Per-cycle compiled-scene pack shared by the level paths: vehicle
        arrays, obstacle window, boundary mode + corridor, constraint flags,
        cost params, and whether the fused scorer's scope applies."""
        dtype = self._dtype
        veh = self._vehicle_arrays()
        obstacles = self._cc.obstacles_for_window(
            self.x_0.time_step, self.N, self.config.planning.factor)
        boundary = self._cc.boundary
        if boundary.segments.shape[0] == 0:
            boundary_mode = "none"
            corridor = None
        else:
            boundary_mode = self.config.planning.boundary_mode
            corridor = self._cc.corridor_for(self._co) \
                if boundary_mode == "corridor" else None

        constraints = self.config.planning.constraints_to_check
        flags = tuple(c in constraints for c in _CONSTRAINT_ORDER)

        cf = self.cost_function
        # fail-safe cost = default formula at w_a=1, desired_d=0 without the
        # velocity/stopping terms (cost_function.py:74-92)
        fail_safe = cf.structure[0] == "fail_safe"
        cost_params = cycle_ops.CostParams(
            w_a=jnp.asarray(1.0 if fail_safe
                            else getattr(cf, "w_a", 0.0), dtype),
            desired_d=jnp.asarray(0.0 if fail_safe
                                  else getattr(cf, "desired_d", 0.0), dtype),
            desired_speed=jnp.asarray(
                getattr(cf, "desired_speed", None) or 0.0, dtype),
            desired_s=jnp.asarray(getattr(cf, "desired_s", None) or 0.0, dtype))

        # kernel_ok: the fused scorer applies at all (float32 programs,
        # default or fail-safe cost).  The modes the scorer does not
        # mask densely — the continuous swept pass and the exact 'segments'
        # boundary SAT — run as LAZY per-winner refinement on every fused
        # path (plan_scan, fused escalation, single-level fast), so the
        # whole reference configuration class stays on the fast path.
        # Trajectory-set capture (draw_traj_set) no longer forces the XLA
        # fallback: the fast paths capture the bundle with one extra XLA
        # rollout dispatch post-selection (_capture_bundle_fast)
        kernel_ok = (self.config.debug.fast_scoring
                     and self._dtype == jnp.float32
                     and cf.structure[0] in ("default", "fail_safe"))
        fast_ok = kernel_ok \
            and boundary_mode in ("corridor", "none", "segments")
        return dict(veh=veh, obstacles=obstacles, boundary=boundary,
                    boundary_mode=boundary_mode, corridor=corridor,
                    flags=flags, cost_params=cost_params, fast_ok=fast_ok,
                    kernel_ok=kernel_ok)

    def _goal_valid_mask(self, batch: CandidateBatch) -> np.ndarray:
        """filter_goals_behind in stopping mode (:1076-1077)."""
        if self.config.sampling.longitudinal_mode == "stopping":
            return np.where(np.isnan(batch.lon_xd_pos), True,
                            batch.lon_x0_pos < batch.lon_xd_pos)
        return np.ones(batch.size, dtype=bool)

    def plan_scan(self, n_cycles: int, record: bool = True,
                  stop_on_goal: bool = True) -> dict:
        """Device-resident multi-cycle replanning: the reference driver's
        cyclic loop (run_planner.py:61-107) as ONE device dispatch.

        Each scan step regenerates every sampling level's grid on device
        around the carried state, scores the level union with the fused
        scorer, selects the first-found level's winner (escalation
        semantics), and advances ``replanning_frequency`` steps — no host
        round-trip between cycles, so the per-dispatch host cost is paid
        once for all cycles instead of once per ``plan()`` call.

        Scope: the fused-kernel scope (``debug.fast_scoring``, float32
        kernels, default cost with a speed target).  Within it, every
        reference planning configuration runs: corridor / ``segments`` /
        no boundary mode, discrete and ``continuous_collision_check``,
        any ``planning.factor`` (obstacle tables are factor-strided),
        Fixed-interval and Corridor sampling spaces, and both longitudinal
        modes (stopping mode requires ``set_desired_lon_position`` first).
        Exact ``segments`` SAT and the swept continuous pass run as lazy
        per-winner refinement inside the scan (a device-side sorted
        ``while_loop``, mirroring the reference's lazy sorted collision
        iteration at reactive_planner.py:1031-1062).  Raises ValueError
        outside the kernel scope.  Standstill STARTS
        work (low-velocity mode runs on device — ZAM-Ramp pinned in tests),
        and the standstill FALLBACK (reactive_planner.py:638-653, :667-713)
        runs ON DEVICE as a ``where``-branch: a blocked scene at v ~ 0
        plans the host's exact standstill trajectory each cycle instead of
        freezing the carry.

        Returns a dict with ``goal_reached``, ``cycles_run``, ``steps``,
        per-cycle ``found``/``best_cost``/rejection counters; with
        ``record=True`` the driven states are appended to
        ``record_state_list`` and the planner state advances to the final
        recorded state (like reset() in the host loop).
        """
        import jax as _jax

        from commonroad_rp_jax.ops import grid as grid_ops
        from commonroad_rp_jax.parallel import pallas_fleet

        assert self.x_0 is not None and self._co is not None
        if not self.x_0_cl:
            self.x_0_cl = self._compute_initial_states(self.x_0)
        self._low_vel_mode = \
            self.x_0.velocity < self.config.planning.low_vel_mode_threshold

        ctx = self._scene_context()
        cf_structure = self.cost_function.structure
        if not ctx["kernel_ok"] or cf_structure[0] != "default" \
                or not cf_structure[1]:
            raise ValueError("plan_scan requires the fused-kernel scope "
                             "(debug.fast_scoring, float32 kernels, "
                             "default cost with speed target)")
        longitudinal_mode = self.config.sampling.longitudinal_mode
        if longitudinal_mode not in ("velocity_keeping", "stopping"):
            raise ValueError(f"plan_scan: unknown longitudinal mode "
                             f"{longitudinal_mode!r}")
        stopping = longitudinal_mode == "stopping"
        if stopping and self._desired_lon_position is None:
            raise ValueError("stopping mode: call set_desired_lon_position() "
                             "before plan_scan")
        factor = self.config.planning.factor
        if self.x_0.time_step % factor != 0:
            raise ValueError(f"plan_scan: initial time_step "
                             f"{self.x_0.time_step} must be divisible by "
                             f"planning.factor {factor}")
        if self._desired_speed is None:
            raise ValueError("call set_desired_velocity() before plan_scan")
        desired_s = float(self._desired_lon_position) if stopping else None
        s_window = None
        if stopping:
            samples_s = self.sampling_space.samples_s
            s_window = (float(samples_s.low), float(samples_s.up))

        cs = self.config.sampling
        corridor_grids = None
        corridor_pin = None
        if isinstance(self.sampling_space, CorridorSampling):
            corridor_pin = self.sampling_space.driving_corridor
            if corridor_pin is None:
                raise ValueError("corridor sampling: set driving_corridor "
                                 "before plan_scan")
            corridor_grids = tuple(
                grid_ops.make_corridor_grid(self.sampling_space, level,
                                            self.dt)
                for level in range(1, self.sampling_level))
            grids = ()
        else:
            grids = tuple(
                grid_ops.make_static_grid(level, cs.t_min, self.horizon,
                                          self.dt, cs.d_min, cs.d_max,
                                          cs.num_sampling_levels)
                for level in range(1, self.sampling_level))

        # full-span obstacle tables: every scenario step the scan can touch,
        # sampled at planning.factor stride (one table row per PLANNED step,
        # reference reactive_planner.py:1032 scaling)
        freq = self.config.planning.replanning_frequency
        span = self.x_0.time_step // factor + n_cycles * freq + self.N + 1
        obstacles_full = collision_ops.compile_obstacles(
            self._cc.scenario, 0, span, factor, dtype=jnp.float32)
        corridor = self._corridor_or_unbounded(ctx["corridor"])

        cf = self.cost_function
        # cache the built scan: rebuilding retraces the whole program (~1 s)
        # even when the compiled executable is cached
        # the key holds the CoordinateSystem object itself (identity
        # compare + a strong ref): an id() key could alias a NEW object
        # allocated at a freed one's address
        lookahead = min(self._standstill_lookahead, self.N)
        # desired_speed is a TRACED input of the scan (not in the key):
        # velocity-tracking missions change it per dispatch without retrace
        boundary_mode = ctx["boundary_mode"]
        continuous = self.config.planning.continuous_collision_check
        cache_key = (n_cycles, freq, self.N, span, self._co,
                     float(getattr(cf, "w_a", 5.0)),
                     float(getattr(cf, "desired_d", 0.0)), ctx["flags"],
                     longitudinal_mode, desired_s, s_window, lookahead,
                     factor, boundary_mode, continuous,
                     None if corridor_pin is None else id(corridor_pin))
        cache = getattr(self, "_plan_scan_cache", None)
        if cache is None:
            from collections import OrderedDict
            cache = self._plan_scan_cache = OrderedDict()
        hit = cache.get(cache_key)
        # the cached value pins the corridor object: an id() key alone could
        # alias a NEW corridor allocated at a freed one's address
        if hit is not None and hit[1] is corridor_pin:
            cache.move_to_end(cache_key)          # LRU refresh
            run = hit[0]
        else:
            run = pallas_fleet.make_facade_replanning_scan(
                self._co.tables, corridor, obstacles_full, ctx["veh"], grids,
                self.dt, self.N, freq,
                self.config.planning.low_vel_mode_threshold, self.horizon,
                float(self._desired_speed), float(getattr(cf, "w_a", 5.0)),
                float(getattr(cf, "desired_d", 0.0)), ctx["flags"], n_cycles,
                longitudinal_mode=longitudinal_mode, desired_s=desired_s,
                s_window=s_window, standstill_lookahead=lookahead,
                boundary=ctx["boundary"] if boundary_mode == "segments"
                else None,
                continuous=continuous, corridor_grids=corridor_grids)
            # LRU over the last few built scans: mode-alternating missions
            # (velocity-keeping <-> stopping) must not retrace per switch
            cache[cache_key] = (run, corridor_pin)
            self._plan_scan_builds = getattr(self, "_plan_scan_builds", 0) + 1
            while len(cache) > 4:
                cache.popitem(last=False)

        x0_lon, x0_lat = self.x_0_cl
        kappa_0 = np.tan(self.x_0.steering_angle) / \
            self.vehicle_params.wheelbase
        carry = pallas_fleet.FacadeScanCarry(
            x0_lon=jnp.asarray(np.asarray(x0_lon), jnp.float32),
            x0_lat=jnp.asarray(np.asarray(x0_lat), jnp.float32),
            orientation=jnp.asarray(self.x_0.orientation, jnp.float32),
            velocity=jnp.asarray(self.x_0.velocity, jnp.float32),
            # the scan indexes obstacle tables in PLANNED steps (tables are
            # factor-strided); scenario steps = planned * factor
            time_step=jnp.asarray(self.x_0.time_step // factor, jnp.int32),
            alive=jnp.asarray(True),
            kappa=jnp.asarray(kappa_0, jnp.float32),
            px=jnp.asarray(self.x_0.position[0], jnp.float32),
            py=jnp.asarray(self.x_0.position[1], jnp.float32))

        t0 = time.time()
        final_carry, metrics = run(carry, float(self._desired_speed))
        found, best_cost, n_inf_kin, n_coll, states = _jax.device_get(metrics)
        wall = time.time() - t0
        self.stage_timers.record("device_scan", wall)
        logger.info("plan_scan: %d cycles in %.4fs (%.2f ms/cycle)",
                    n_cycles, wall, wall / max(n_cycles, 1) * 1e3)

        found = np.asarray(found)
        states = np.asarray(states)                 # [C, 14, freq+1]
        goal = self.config.planning_problem.goal
        wb = self.vehicle_params.wb_rear_axle

        cycles_run = 0
        steps = 0
        goal_reached = False
        last_state = None
        t_start = self.x_0.time_step
        prev_theta = self.x_0.orientation
        prev_lon_lat = None
        for c in range(n_cycles):
            if not found[c]:
                break
            cycles_run += 1
            arr = states[c]
            for offset in range(1, freq + 1):
                steps += 1
                theta = float(arr[9, offset])
                state = ReactivePlannerState(
                    # scenario steps advance factor per planned step
                    # (reactive_planner.py:1032)
                    time_step=t_start + factor * ((c * freq) + offset),
                    position=np.array([arr[7, offset], arr[8, offset]]),
                    orientation=theta,
                    velocity=float(arr[10, offset]),
                    acceleration=float(arr[11, offset]),
                    yaw_rate=(theta - prev_theta) / self.dt,
                    steering_angle=float(np.arctan2(
                        self.vehicle_params.wheelbase * arr[12, offset], 1.0)))
                prev_theta = theta
                last_state = state
                prev_lon_lat = (list(arr[0:3, offset]), list(arr[3:6, offset]))
                if record:
                    self.record_state_and_input(state)
                shifted = state.shift_positions_to_center(wb)
                if goal.is_reached(shifted):
                    # stop_on_goal=False keeps driving (stop-at-goal
                    # missions: the scan must continue INSIDE the goal
                    # region until the stopping mode halts the vehicle)
                    goal_reached = True
                    if stop_on_goal:
                        break
            if goal_reached and stop_on_goal:
                break

        if record and last_state is not None:
            # advance the planner like the host loop's reset()
            self.reset(initial_state_cart=last_state,
                       initial_state_curv=prev_lon_lat,
                       collision_checker=self._cc,
                       coordinate_system=self._co)
        if cycles_run:
            self._infeasible_count_kinematics = int(n_inf_kin[cycles_run - 1])
            self._infeasible_count_collision = int(n_coll[cycles_run - 1])
            self._optimal_cost = float(best_cost[cycles_run - 1])

        return dict(goal_reached=goal_reached, cycles_run=cycles_run,
                    steps=steps, found=found[:cycles_run].tolist(),
                    best_cost=np.asarray(best_cost)[:cycles_run].tolist(),
                    n_inf_kinematics=np.asarray(n_inf_kin)[:cycles_run].tolist(),
                    n_inf_collision=np.asarray(n_coll)[:cycles_run].tolist(),
                    wall_time=wall)

    def _get_optimal_trajectory(self, batch: CandidateBatch):
        """One level through the device program (replaces
        reactive_planner.py:1065-1136)."""
        self._reset_statistics()
        dtype = self._dtype

        goal_valid = self._goal_valid_mask(batch)
        ctx = self._scene_context()
        veh = ctx["veh"]
        obstacles = ctx["obstacles"]
        boundary = ctx["boundary"]
        boundary_mode = ctx["boundary_mode"]
        corridor = ctx["corridor"]
        flags = ctx["flags"]
        cost_params = ctx["cost_params"]
        cf = self.cost_function

        # fused-scorer fast path (config.debug.fast_scoring) within its
        # scope; anything outside it falls through to the
        # XLA conformance program below
        if ctx["fast_ok"]:
            return self._get_optimal_trajectory_fast(
                batch, goal_valid, veh, obstacles, corridor, flags,
                cost_params,
                boundary=boundary if boundary_mode == "segments" else None,
                continuous=self.config.planning.continuous_collision_check)

        t0 = time.time()
        result = cycle_ops.evaluate_level(
            jnp.asarray(batch.coeffs_lon, dtype), jnp.asarray(batch.coeffs_lat, dtype),
            jnp.asarray(batch.traj_len), jnp.asarray(goal_valid),
            self._co.tables, veh, obstacles,
            boundary if boundary_mode == "segments" else None, corridor,
            jnp.asarray(self.x_0.orientation, dtype), cost_params,
            dt=self.dt, n_steps=self.N, low_vel_mode=self._low_vel_mode,
            cost_structure=cf.structure, constraint_flags=flags,
            boundary_mode=boundary_mode,
            continuous_check=self.config.planning.continuous_collision_check)

        # minimal host readbacks on the hot path: ONE batched transfer of
        # the [4] scalar pack + [14,T] candidate pack (each np.asarray is a
        # separate device sync); found is derived from the winner cost (inf = none).
        # The per-constraint statistics ([3,K] masks) and cost distribution
        # ([K]) are read back lazily only when consumed (debug logging,
        # properties, viz)
        import jax as _jax
        scalars, optimal_packed = _jax.device_get((result.scalars,
                                                   result.optimal))
        scalars = np.asarray(scalars)
        found = bool(np.isfinite(scalars[1]))
        self.stage_timers.record("device_cycle", time.time() - t0)
        logger.debug("Device cycle evaluation took \t%.7fs", time.time() - t0)

        # statistics with reference lazy-iteration semantics; goal-filtered
        # candidates never enter the kinematic check (:1076-1077)
        self._infeasible_count_kinematics = int(scalars[2])
        self._infeasible_count_collision = int(scalars[3])
        self._pending_reason_stats = ("xla", result.masks, goal_valid)

        want_details = (self._draw_traj_set or
                        logger.isEnabledFor(logging.DEBUG))
        if want_details:
            masks = np.asarray(result.masks)
            feasible = masks[0].astype(bool)
            collides = masks[1].astype(bool)
            costs = np.asarray(result.costs)
        if self._draw_traj_set:
            self.stored_trajectories = BundleSummary(
                x=np.asarray(result.rollout.x), y=np.asarray(result.rollout.y),
                costs=costs, feasible=feasible, collides=collides)

        return self._finalize_level(found, scalars, optimal_packed,
                                    costs[feasible] if want_details else None)

    def _finalize_level(self, found: bool, scalars: np.ndarray,
                        optimal_packed, feas_costs):
        """Shared tail of both level-evaluation paths: bundle statistics,
        not-found handling, and the winner unpack into OptimalTrajectory.
        ``feas_costs`` is the kinematically feasible candidates' raw costs
        (None when the caller skipped the detail readback)."""
        bundle_stats = None
        if feas_costs is not None:
            bundle_stats = {
                "cost_min": float(feas_costs.min()) if feas_costs.size else 0.0,
                "cost_span": float(feas_costs.max() - feas_costs.min())
                if feas_costs.size else 0.0,
            }
        if not found:
            return None, bundle_stats

        arrays = cycle_ops.unpack_candidate(optimal_packed)
        optimal = OptimalTrajectory(arrays=arrays, cost=float(scalars[1]),
                                    dt=self.dt, horizon=self.horizon)
        logger.debug("Selected candidate %d with cost %.3f", int(scalars[0]),
                     optimal.cost)
        return optimal, bundle_stats

    def _corridor_or_unbounded(self, corridor):
        """The fused scorer always takes corridor bands; without a road
        boundary the bands are unbounded."""
        if corridor is not None:
            return corridor
        P = int(np.asarray(self._co.tables.s).shape[0])
        # +-BAND_CLAMP (the band-value contract, collision.py): a 32 m band
        # never binds under the 19.9 m lateral projection-domain cap
        return collision_ops.CorridorArrays(
            d_lo=jnp.full((P,), -collision_ops.BAND_CLAMP, jnp.float32),
            d_hi=jnp.full((P,), collision_ops.BAND_CLAMP, jnp.float32))

    def _plan_all_levels_fast(self, x_0_lon, x_0_lat, start_level: int):
        """Fused level escalation on the fused scorer: every remaining
        sampling level's bundle is scored in ONE device dispatch, and the
        winner comes from the first level with a feasible candidate —
        identical selections and statistics to the sequential escalation
        loop (reactive_planner.py:616-636), at one kernel launch + one
        readback per cycle instead of one per level.  Returns None when the
        fast-path scope does not apply (caller falls back to the loop).
        """
        import jax as _jax

        ctx = self._scene_context()
        if not ctx["fast_ok"]:
            return None

        levels = list(range(start_level, self.sampling_level))
        if not levels:
            return None
        batches = []
        with self.stage_timers.stage("grid_generation"):
            for level in levels:
                batches.append(
                    self._create_trajectory_bundle(x_0_lon, x_0_lat, level))
        coeffs_lon = np.concatenate([b.coeffs_lon for b in batches])
        coeffs_lat = np.concatenate([b.coeffs_lat for b in batches])
        traj_len = np.concatenate([b.traj_len for b in batches])
        goal_valid = np.concatenate([self._goal_valid_mask(b) for b in batches])
        level_ids = np.concatenate([np.full(b.size, j, np.int32)
                                    for j, b in enumerate(batches)])
        logger.info("Fused levels %d..%d: %d candidates, one dispatch",
                    start_level + 1, self.sampling_level, len(level_ids))

        self._reset_statistics()
        dtype = jnp.float32
        corridor = self._corridor_or_unbounded(ctx["corridor"])
        t0 = time.time()
        result = cycle_ops.evaluate_levels_fast(
            jnp.asarray(coeffs_lon, dtype), jnp.asarray(coeffs_lat, dtype),
            jnp.asarray(traj_len), jnp.asarray(goal_valid),
            jnp.asarray(level_ids), self._co.tables, ctx["veh"],
            ctx["obstacles"], corridor,
            jnp.asarray(self.x_0.orientation, dtype), ctx["cost_params"],
            ctx["boundary"] if ctx["boundary_mode"] == "segments" else None,
            dt=self.dt, n_steps=self.N, low_vel_mode=self._low_vel_mode,
            cost_structure=self.cost_function.structure,
            constraint_flags=ctx["flags"], n_levels=len(levels),
            continuous=self.config.planning.continuous_collision_check)
        scalars, optimal_packed = _jax.device_get((result.scalars,
                                                   result.optimal))
        scalars = np.asarray(scalars)
        found = bool(np.isfinite(scalars[1]))
        self.stage_timers.record("device_cycle", time.time() - t0)
        logger.debug("Fused device cycle took \t%.7fs", time.time() - t0)

        stat_level = int(scalars[5])
        self._infeasible_count_kinematics = int(scalars[2])
        self._infeasible_count_collision = int(scalars[3])
        if found and scalars[4] < 0.5:
            logger.warning("fast path: selected winner fails the exact "
                           "feasibility re-check; consider the XLA path "
                           "(debug.fast_scoring: False) for this scenario")
        level_mask = level_ids == stat_level
        self._pending_reason_stats = ("fast", result.reasons,
                                      result.kin_costs,
                                      goal_valid & level_mask)
        logger.info("Selected sampling level %d/%d (%d candidates)",
                    start_level + stat_level + 1, self.sampling_level,
                    batches[stat_level].size)
        logger.info("Rejected %d kinematically infeasible, %d colliding",
                    self._infeasible_count_kinematics,
                    self._infeasible_count_collision)
        if self._draw_traj_set:
            # capture the SELECTED level's slice (the XLA escalation loop
            # stores the level it stopped at, matching the reference's
            # per-level drawing path)
            sel = level_mask
            self._capture_bundle_fast(coeffs_lon[sel], coeffs_lat[sel],
                                      traj_len[sel], goal_valid[sel])

        feas_costs = None
        if logger.isEnabledFor(logging.DEBUG):
            kin_costs = np.asarray(result.kin_costs)
            feas_costs = kin_costs[np.isfinite(kin_costs) & level_mask]
        return self._finalize_level(found, scalars, optimal_packed, feas_costs)

    def _get_optimal_trajectory_fast(self, batch: CandidateBatch, goal_valid,
                                     veh, obstacles, corridor, flags,
                                     cost_params, boundary=None,
                                     continuous: bool = False):
        """Level evaluation on the fused scorer
        (``config.debug.fast_scoring``).

        Only three [K] rows and the winner's [14, T] pack leave the
        device.  Rejection counters are
        exact (reconstructed from the cost rows with the reference's
        lazy-iteration semantics); the per-constraint reason dict is
        unavailable, the same statistics loss the reference exhibits in
        multiprocessing mode (reactive_planner.py:962-967).
        """
        dtype = jnp.float32
        corridor = self._corridor_or_unbounded(corridor)

        t0 = time.time()
        result = cycle_ops.evaluate_level_fast(
            jnp.asarray(batch.coeffs_lon, dtype),
            jnp.asarray(batch.coeffs_lat, dtype),
            jnp.asarray(batch.traj_len), jnp.asarray(goal_valid),
            self._co.tables, veh, obstacles, corridor,
            jnp.asarray(self.x_0.orientation, dtype), cost_params, boundary,
            dt=self.dt, n_steps=self.N, low_vel_mode=self._low_vel_mode,
            cost_structure=self.cost_function.structure,
            constraint_flags=flags, continuous=continuous)
        import jax as _jax
        scalars, optimal_packed = _jax.device_get((result.scalars,
                                                   result.optimal))
        scalars = np.asarray(scalars)
        found = bool(np.isfinite(scalars[1]))
        self.stage_timers.record("device_cycle", time.time() - t0)
        logger.debug("Device cycle evaluation (fast path) took \t%.7fs",
                     time.time() - t0)

        self._infeasible_count_kinematics = int(scalars[2])
        self._infeasible_count_collision = int(scalars[3])
        if found and scalars[4] < 0.5:
            # the float32 dense scoring and the winner re-roll disagree
            # on a boundary-tight feasibility verdict
            logger.warning("fast path: selected winner fails the exact "
                           "feasibility re-check; consider the XLA path "
                           "(debug.fast_scoring: False) for this scenario")
        self._pending_reason_stats = ("fast", result.reasons,
                                      result.kin_costs, goal_valid)
        if self._draw_traj_set:
            self._capture_bundle_fast(batch.coeffs_lon, batch.coeffs_lat,
                                      batch.traj_len, goal_valid)

        feas_costs = None
        if logger.isEnabledFor(logging.DEBUG):
            kin_costs = np.asarray(result.kin_costs)
            feas_costs = kin_costs[np.isfinite(kin_costs)]
        return self._finalize_level(found, scalars, optimal_packed, feas_costs)

    def _capture_bundle_fast(self, coeffs_lon, coeffs_lat, traj_len,
                             goal_valid):
        """Trajectory-set capture on the fast path (draw_traj_set).

        One extra XLA ``evaluate_level`` dispatch AFTER the fused selection
        reproduces the bundle's [K, T] Cartesian states and the dense
        feasibility/collision labels for visualization (reference drawing
        path, reactive_planner.py:1122-1123 + visualization.py:143-148) —
        bit-for-bit the same BundleSummary the XLA conformance path stores.
        The fused scorer remains the SELECTION path; this dispatch only
        feeds the renderer, so its extra cost is paid only when drawing.
        """
        import jax as _jax

        ctx = self._scene_context()
        # the fast path requires self._dtype == float32, so the scene trees
        # are already in the layout evaluate_level wants
        dtype = self._dtype
        with _jax.enable_x64(False):
            boundary_mode = ctx["boundary_mode"]
            result = cycle_ops.evaluate_level(
                jnp.asarray(coeffs_lon, dtype), jnp.asarray(coeffs_lat, dtype),
                jnp.asarray(traj_len), jnp.asarray(goal_valid),
                self._co.tables, ctx["veh"], ctx["obstacles"],
                ctx["boundary"] if boundary_mode == "segments" else None,
                ctx["corridor"],
                jnp.asarray(self.x_0.orientation, dtype), ctx["cost_params"],
                dt=self.dt, n_steps=self.N, low_vel_mode=self._low_vel_mode,
                cost_structure=self.cost_function.structure,
                constraint_flags=ctx["flags"], boundary_mode=boundary_mode,
                continuous_check=self.config.planning
                .continuous_collision_check)
            x, y, costs, masks = _jax.device_get(
                (result.rollout.x, result.rollout.y, result.costs,
                 result.masks))
        masks = np.asarray(masks)
        self.stored_trajectories = BundleSummary(
            x=np.asarray(x), y=np.asarray(y), costs=np.asarray(costs),
            feasible=masks[0].astype(bool), collides=masks[1].astype(bool))

    def _vehicle_arrays(self) -> kin_ops.VehicleArrays:
        v = self.vehicle_params
        d = self._dtype
        return kin_ops.VehicleArrays(
            wheelbase=jnp.asarray(v.wheelbase, d),
            wb_rear_axle=jnp.asarray(v.wb_rear_axle, d),
            a_max=jnp.asarray(v.a_max, d), v_switch=jnp.asarray(v.v_switch, d),
            kappa_max=jnp.asarray(np.tan(v.delta_max) / v.wheelbase, d),
            v_delta_max=jnp.asarray(v.v_delta_max, d),
            half_length=jnp.asarray(0.5 * v.length, d),
            half_width=jnp.asarray(0.5 * v.width, d))

    # ------------------------------------------------------------------
    # standstill fallback (reactive_planner.py:667-713)
    # ------------------------------------------------------------------

    def _compute_standstill_trajectory(self) -> OptimalTrajectory:
        x_0 = self.x_0
        x_0_lon, x_0_lat = self.x_0_cl
        N = self.N

        kappa_0 = np.tan(x_0.steering_angle) / self.vehicle_params.wheelbase

        a = np.repeat(0.0, N)
        a[1] = -self.x_0.velocity / self.dt

        ref_pos = self._co.ref_pos
        s_idx = int(np.argmax(ref_pos > x_0_lon[0])) - 1
        ref_theta = np.unwrap(self._co.ref_theta)
        theta_cl = x_0.orientation - interpolate_angle(
            x_0_lon[0], ref_pos[s_idx], ref_pos[s_idx + 1],
            ref_theta[s_idx], ref_theta[s_idx + 1])

        rep = lambda val: np.repeat(float(val), N)
        arrays = dict(
            x=rep(x_0.position[0]), y=rep(x_0.position[1]),
            theta_gl=rep(x_0.orientation), v=rep(0.0), a=a,
            kappa_gl=rep(kappa_0), kappa_dot=rep(0.0),
            s=rep(x_0_lon[0]), s_dot=rep(x_0_lon[1]), s_ddot=rep(x_0_lon[2]),
            d=rep(x_0_lat[0]), d_dot=rep(x_0_lat[1]), d_ddot=rep(x_0_lat[2]),
            theta_cl=rep(theta_cl))
        return OptimalTrajectory(arrays=arrays, cost=0.0, dt=self.dt,
                                 horizon=self.horizon)

    # ------------------------------------------------------------------
    # output assembly (reactive_planner.py:514-568)
    # ------------------------------------------------------------------

    def _compute_trajectory_pair(self, trajectory: OptimalTrajectory
                                 ) -> Tuple[Trajectory, Trajectory, List, List]:
        arr = trajectory.arrays
        cart_list, cl_list, lon_list, lat_list = [], [], [], []
        scaling_factor = self.config.planning.factor
        length = len(arr["x"])
        for i in range(length):
            yaw_rate = (arr["theta_gl"][i] - arr["theta_gl"][i - 1]) / self.dt \
                if i > 0 else self.x_0.yaw_rate
            cart_list.append(ReactivePlannerState(
                time_step=self.x_0.time_step + scaling_factor * i,
                position=np.array([arr["x"][i], arr["y"][i]]),
                orientation=arr["theta_gl"][i], velocity=arr["v"][i],
                acceleration=arr["a"][i], yaw_rate=yaw_rate,
                steering_angle=np.arctan2(
                    self.vehicle_params.wheelbase * arr["kappa_gl"][i], 1.0)))
            cl_list.append(TraceState(
                time_step=self.x_0.time_step + scaling_factor * i,
                position=np.array([arr["s"][i], arr["d"][i]]),
                velocity=arr["v"][i], acceleration=arr["a"][i],
                orientation=arr["theta_gl"][i], yaw_rate=arr["kappa_gl"][i]))
            lon_list.append([arr["s"][i], arr["s_dot"][i], arr["s_ddot"][i]])
            lat_list.append([arr["d"][i], arr["d_dot"][i], arr["d_ddot"][i]])

        cart_traj = Trajectory(self.x_0.time_step, cart_list)
        cl_traj = Trajectory(self.x_0.time_step, cl_list)
        # wrap output orientations around x_0 (reactive_planner.py:565-566)
        shift_orientation_states(cart_traj.state_list,
                                 interval_start=self.x_0.orientation - np.pi,
                                 interval_end=self.x_0.orientation + np.pi)
        return cart_traj, cl_traj, lon_list, lat_list

    def convert_state_list_to_commonroad_object(self, state_list, obstacle_id: int = 42):
        """Planner output -> dynamic-obstacle prediction
        (reactive_planner.py:1138-1159)."""
        from commonroad_rp_jax.utils.scenario import (DynamicObstacle,
                                                      Rectangle)
        shifted = [s.shift_positions_to_center(self.vehicle_params.wb_rear_axle)
                   for s in state_list]
        shape = Rectangle(self.vehicle_params.length, self.vehicle_params.width)
        return DynamicObstacle(obstacle_id, "car", shape, shifted[0],
                               trajectory=shifted)
