"""Planner facade: the batched ``MotionPlanner``.

Mirrors the public API of the reference planner (/root/reference/mpc_solver/
motionPlanner.{hpp,cpp}) — margins, current/target state handling,
jerk-limited warm start, SQP solve, trajectory sampling, random-state
sampling and feasibility checks — re-designed so that every solve is a pure
batched function: states carry a leading batch axis, one ``solve`` call
plans B trajectories simultaneously, and the whole pipeline jits/shards.

Reference solver knobs reproduced (motionPlanner.cpp:12-24): SQP max_iter=2,
QP max_iter=700 with eps_abs=eps_rel=1e-3, line_search_max_iter=10,
normalized time in [0,1] with t_f in [0,10] s, terminal box eps=1e-2,
margins applied as fractional shrinkage of the Franka limits.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .config import full_precision
from .models.panda import TOOL_FRAME, PandaLimits, make_panda_limits, make_panda_model
from .models.robot import RobotModel
from .ocp import NLPBounds, TranscribedOCP, assemble_bounds, make_ocp
from .ops import kinematics, rnea
from .ops.collocation import interpolate
from .ops.otg import JerkLimitedTrajectory, plan_trajectory
from .ops.qp import QPSettings
from .ops.sqp import SQPResult, SQPSettings, sqp_solve

INF = float("inf")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Margins:
    """Fractional margins on the robot limits (motionPlanner.cpp:56-90)."""

    position: float = dataclasses.field(default=1.0, metadata={"static": True})
    velocity: float = dataclasses.field(default=1.0, metadata={"static": True})
    acceleration: float = dataclasses.field(default=1.0, metadata={"static": True})
    torque: float = dataclasses.field(default=1.0, metadata={"static": True})
    jerk: float = dataclasses.field(default=1.0, metadata={"static": True})


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Solution:
    """Result of a batched solve: solver state + trajectory accessors."""

    ocp: TranscribedOCP
    z: jax.Array  # (B, num_var)
    lam_c: jax.Array
    lam_x: jax.Array
    violation: jax.Array  # (B,)
    qp_iterations: jax.Array  # (B, sqp_iters)
    qp_converged: jax.Array
    step_sizes: jax.Array
    # The OTG trajectory used to seed the solve, or None for hot-restart
    # solves (solve(z0=...)), which skip OTG planning entirely — mirroring
    # solve_trajectory(false), motionPlanner.cpp:179-181. When present it
    # is ALWAYS the actual seed; consumers (benchmark_records) never
    # validate a trajectory that did not seed the solve.
    warm_start: Optional[JerkLimitedTrajectory]

    @property
    def final_time(self):
        """t_f = p (seconds), shape (B,)."""
        return self.z[..., -1]

    def states(self):
        X, U, p = self.ocp.unpack(self.z)
        return X, U, p

    @full_precision
    def x_at(self, t_norm):
        """State at normalized time(s) t in [0,1]: (B, ..., nx)."""
        X, _, _ = self.states()
        return jax.vmap(lambda Xb: interpolate(self.ocp.coll, Xb, t_norm))(X)

    @full_precision
    def u_at(self, t_norm):
        _, U, _ = self.states()
        return jax.vmap(lambda Ub: interpolate(self.ocp.coll, Ub, t_norm))(U)

    @full_precision
    def sample(self, n_points: int):
        """Sample the MPC trajectory at n_points+1 uniform times.

        Returns (time (B, N+1), q, qdot, qddot, tau each (B, N+1, nq)) with
        time de-normalized by t_f — get_MPC_trajectory semantics
        (motionPlanner.hpp:99-116).
        """
        t_norm = jnp.linspace(0.0, 1.0, n_points + 1).astype(self.z.dtype)
        x = self.x_at(t_norm)
        u = self.u_at(t_norm)
        nq = self.ocp.nq
        q, qd = x[..., :nq], x[..., nq:]
        tau = jax.vmap(jax.vmap(lambda a, b, c: rnea.rnea(self.ocp.model, a, b, c)))(
            q, qd, u
        )
        time = t_norm[None, :] * self.final_time[:, None]
        return time, q, qd, u, tau

    def reseed_guess(self, current_state, target_state):
        """Warm-start vector for a hot restart: the solution with first/last
        node pinned to the (new) boundary states (motionPlanner.cpp:199-207)."""
        nx = self.ocp.nx
        z = self.z
        z = z.at[..., :nx].set(current_state)
        n0 = (self.ocp.num_nodes - 1) * nx
        z = z.at[..., n0 : n0 + nx].set(target_state)
        return z


class MotionPlanner:
    """User-facing planner. Construction is host-side; solves are pure."""

    def __init__(
        self,
        model: Optional[RobotModel] = None,
        limits: Optional[PandaLimits] = None,
        tool_frame: str = TOOL_FRAME,
        margins: Margins = Margins(),
        sqp_settings: SQPSettings = SQPSettings(),
        qp_settings: QPSettings = QPSettings(),
        target_eps: float = 1e-2,
        time_bounds: Tuple[float, float] = (0.0, 10.0),
        dtype=None,
    ):
        self.model = (model or make_panda_model()).astype(dtype) if dtype else (
            model or make_panda_model()
        )
        self.limits = (limits or make_panda_limits()).astype(dtype) if dtype else (
            limits or make_panda_limits()
        )
        self.ocp = make_ocp(self.model, tool_frame, dtype=dtype)
        self.margins = margins
        self.sqp_settings = sqp_settings
        self.qp_settings = qp_settings
        self.target_eps = target_eps
        self.time_bounds = time_bounds
        self._tool = self.model.frame(tool_frame)
        self._min_height: Optional[float] = None  # None -> limits.min_height

    # ---------------- margin-scaled limits ----------------

    def set_constraint_margins(self, position, velocity, acceleration, torque, jerk):
        self.margins = Margins(position, velocity, acceleration, torque, jerk)

    def position_bounds(self):
        """Shrunk asymmetric position box (motionPlanner.cpp:69)."""
        lim, m = self.limits, self.margins
        safety = (1.0 - m.position) * (lim.max_position - lim.min_position) / 2.0
        return lim.min_position + safety, lim.max_position - safety

    def state_bounds(self):
        lo_q, hi_q = self.position_bounds()
        v = self.margins.velocity * self.limits.max_velocity
        return jnp.concatenate([lo_q, -v]), jnp.concatenate([hi_q, v])

    def control_bounds(self):
        a = self.margins.acceleration * self.limits.max_acceleration
        return -a, a

    def ineq_bounds(self, min_height: Optional[float] = None):
        """Torque box + height (set_min_height, motionPlanner.cpp:92-100)."""
        if min_height is None:
            min_height = self._min_height
        h = self.limits.min_height if min_height is None else min_height
        t = self.margins.torque * self.limits.max_torque
        dt = t.dtype
        lo = jnp.concatenate([-t, jnp.asarray([h], dt)])
        hi = jnp.concatenate([t, jnp.asarray([INF], dt)])
        return lo, hi

    def nlp_bounds(self, current_state, target_state, min_height=None) -> NLPBounds:
        s_lo, s_hi = self.state_bounds()
        c_lo, c_hi = self.control_bounds()
        g_lo, g_hi = self.ineq_bounds(min_height)

        def one(cur, tgt):
            return assemble_bounds(
                self.ocp,
                cur,
                tgt,
                s_lo,
                s_hi,
                c_lo,
                c_hi,
                self.time_bounds[0],
                self.time_bounds[1],
                g_lo,
                g_hi,
                self.target_eps,
            )

        if current_state.ndim > 1:
            return jax.vmap(one)(current_state, target_state)
        return one(current_state, target_state)

    # ---------------- warm start ----------------

    @full_precision
    def plan_warm_start(
        self,
        current_state,
        target_state,
        current_acceleration=None,
        target_acceleration=None,
    ) -> JerkLimitedTrajectory:
        """Jerk-limited time-optimal trajectory between the boundary states
        (warm_start_RK, motionPlanner.cpp:146-175). Boundary accelerations
        default to zero but are honored when given, mirroring the reference
        API's current/target acceleration plumbing into Ruckig's
        InputParameter (motionPlanner.cpp:27-54, motionPlanner.hpp:35-37)."""
        nq = self.ocp.nq
        m = self.margins
        return plan_trajectory(
            current_state[..., :nq],
            current_state[..., nq:],
            target_state[..., :nq],
            target_state[..., nq:],
            m.velocity * self.limits.max_velocity,
            m.acceleration * self.limits.max_acceleration,
            m.jerk * self.limits.max_jerk,
            start_acceleration=current_acceleration,
            target_acceleration=target_acceleration,
        )

    @full_precision
    def warm_start_vector(self, traj: JerkLimitedTrajectory):
        """Sample the OTG trajectory at the collocation nodes and pack the
        initial NLP iterate with p0 = OTG duration."""
        t_nodes = self.ocp.coll.time_nodes  # (nodes,) in [0,1]

        def one(tr):
            ts = t_nodes * tr.duration
            p, v, a = jax.vmap(tr.at_time)(ts)
            X = jnp.concatenate([p, v], axis=-1)
            return self.ocp.pack(X, a, jnp.atleast_1d(tr.duration))

        batched = traj.duration.ndim > 0
        return jax.vmap(one)(traj) if batched else one(traj)

    def warm_start_from_trajectory(
        self, final_time, position, velocity, acceleration
    ):
        """Warm-start vector from any regularly-time-spaced trajectory
        (generic ``warm_start``, motionPlanner.hpp:145-172): picks the
        nearest sample to each collocation node and packs p0 = final_time.

        position/velocity/acceleration: (..., n_points, nq)."""
        n_points = position.shape[-2]
        t_nodes = self.ocp.coll.time_nodes
        idx = jnp.round(t_nodes * (n_points - 1)).astype(jnp.int32)

        def one(pos, vel, acc, tf):
            X = jnp.concatenate([pos[idx], vel[idx]], axis=-1)
            return self.ocp.pack(X, acc[idx], jnp.atleast_1d(tf))

        if position.ndim > 2:
            return jax.vmap(one)(position, velocity, acceleration,
                                 jnp.asarray(final_time))
        return one(position, velocity, acceleration, jnp.asarray(final_time))

    @full_precision
    def warm_start_point(self, traj: JerkLimitedTrajectory, t):
        """Warm-start trajectory state at time t (seconds), with torque
        (get_RK_point, motionPlanner.hpp:130-142)."""
        q, v, a = traj.at_time(t)
        if q.ndim > 1:
            tau = jax.vmap(lambda a_, b_, c_: rnea.rnea(self.model, a_, b_, c_))(q, v, a)
        else:
            tau = rnea.rnea(self.model, q, v, a)
        return q, v, a, tau

    @full_precision
    def solution_point(self, solution: "Solution", t):
        """MPC trajectory state at time t (seconds), with torque
        (get_MPC_point, motionPlanner.hpp:118-128): t is de-normalized by
        the solved final time and clamped."""
        t_norm = jnp.clip(
            jnp.asarray(t, solution.z.dtype) / jnp.maximum(solution.final_time, 1e-9),
            0.0,
            1.0,
        )
        nq = self.ocp.nq
        X, U, _ = solution.states()
        x = jax.vmap(lambda Xb, tb: interpolate(self.ocp.coll, Xb, tb))(X, t_norm)
        u = jax.vmap(lambda Ub, tb: interpolate(self.ocp.coll, Ub, tb))(U, t_norm)
        q, v = x[..., :nq], x[..., nq:]
        tau = jax.vmap(lambda a_, b_, c_: rnea.rnea(self.model, a_, b_, c_))(q, v, u)
        return q, v, u, tau

    def set_min_height(self, min_height: float):
        """Persistently override the end-effector height floor
        (set_min_height, motionPlanner.cpp:92-100)."""
        self._min_height = min_height

    # ---------------- solve ----------------

    @full_precision
    def solve(
        self,
        current_state,
        target_state,
        z0=None,
        min_height=None,
        lam_c0=None,
        lam_x0=None,
    ) -> Solution:
        """Batched minimum-time solve (solve_trajectory semantics).

        current_state/target_state: (B, 2*nq). If z0 is None an OTG warm
        start is planned and used (use_ruckig_as_warm_start=true); when z0
        is given (the hot-restart path, typically Solution.reseed_guess of
        the previous solve) NO OTG trajectory is planned — mirroring
        solve_trajectory(false), which skips Ruckig entirely
        (motionPlanner.cpp:179-181) — and Solution.warm_start is None.

        lam_c0/lam_x0 optionally seed the SQP dual estimates; the reference
        solver object keeps its duals across solves, so hot-restart chains
        may carry them from the previous SQPResult.
        """
        if z0 is None:
            traj = self.plan_warm_start(current_state, target_state)
            z0 = self.warm_start_vector(traj)
        else:
            traj = None
        bounds = self.nlp_bounds(current_state, target_state, min_height)
        res: SQPResult = sqp_solve(
            self.ocp, bounds, z0, self.sqp_settings, self.qp_settings,
            lam_c0=lam_c0, lam_x0=lam_x0,
        )
        return Solution(
            ocp=self.ocp,
            z=res.z,
            lam_c=res.lam_c,
            lam_x=res.lam_x,
            violation=res.violation,
            qp_iterations=res.qp_iterations,
            qp_converged=res.qp_converged,
            step_sizes=res.step_sizes,
            warm_start=traj,
        )

    # ---------------- sampling & checks ----------------

    @full_precision
    def sample_random_state(self, key, batch_shape=(), max_rounds: int = 64):
        """Random (position, velocity) with tool-side height rejection
        (motionPlanner.cpp:102-114; the reference rejects on the z of
        joint 7's placement, data.oMi[7], not the tool frame)."""
        lo_q, hi_q = self.position_bounds()
        vmax = self.margins.velocity * self.limits.max_velocity
        nq = self.ocp.nq

        def joint7_height(q):
            _, p = kinematics.fk(self.model, q)
            return p[nq - 1, 2]

        height = jax.vmap(joint7_height) if batch_shape else joint7_height

        def sample_q(k):
            return jax.random.uniform(
                k, (*batch_shape, nq), lo_q.dtype, lo_q, hi_q
            )

        def cond(carry):
            k, q, rounds = carry
            bad = height(q) < self.limits.min_height
            return jnp.any(bad) & (rounds < max_rounds)

        def body(carry):
            k, q, rounds = carry
            k, sub = jax.random.split(k)
            q_new = sample_q(sub)
            bad = height(q) < self.limits.min_height
            q = jnp.where(
                bad[..., None] if batch_shape else bad, q_new, q
            )
            return k, q, rounds + 1

        key, sub, sub_v = jax.random.split(key, 3)
        q0 = sample_q(sub)
        _, q, _ = jax.lax.while_loop(cond, body, (key, q0, jnp.asarray(0)))
        v = jax.random.uniform(sub_v, (*batch_shape, nq), vmax.dtype, -vmax, vmax)
        return q, v

    def check_state_in_bounds(self, position, velocity, acceleration=None):
        """Feasibility flag, reference encoding (motionPlanner.cpp:116-144):
        0 ok, 1 position, 2 velocity, 3 both, +10 acceleration."""
        lo_q, hi_q = self.position_bounds()
        vmax = self.margins.velocity * self.limits.max_velocity
        amax = self.margins.acceleration * self.limits.max_acceleration
        pos_bad = jnp.any((position > hi_q) | (position < lo_q), axis=-1)
        vel_bad = jnp.any(jnp.abs(velocity) > vmax, axis=-1)
        flag = pos_bad.astype(jnp.int32) + 2 * vel_bad.astype(jnp.int32)
        if acceleration is not None:
            acc_bad = jnp.any(jnp.abs(acceleration) > amax, axis=-1)
            flag = flag + 10 * acc_bad.astype(jnp.int32)
        return flag

    # ---------------- task-space helpers ----------------

    @full_precision
    def forward_velocities(self, q, qdot):
        return kinematics.forward_velocities(self.model, q, qdot, self._tool)

    @full_precision
    def inverse_velocities(self, q, linear_velocity, angular_velocity):
        return kinematics.inverse_velocities(
            self.model, q, linear_velocity, angular_velocity, self._tool
        )

    @full_precision
    def inverse_kinematics(self, rotation, translation, q0=None, key=None, **kw):
        """Damped-LS IK to a tool pose (pandaWrapper.cpp:14-58). Like the
        reference, the start configuration defaults to a random one
        (pinocchio::randomConfiguration) — pass `key` for reproducibility."""
        if q0 is None:
            key = jax.random.PRNGKey(0) if key is None else key
            q0 = jax.random.uniform(
                key,
                (self.ocp.nq,),
                self.limits.min_position.dtype,
                self.limits.min_position,
                self.limits.max_position,
            )
        return kinematics.inverse_kinematics(
            self.model, q0, rotation, translation, self._tool, **kw
        )

    @full_precision
    def sample_warm_start(self, traj: JerkLimitedTrajectory, n_points: int):
        """Sample the OTG trajectory at n_points+1 uniform times incl.
        torques (get_ruckig_trajectory, motionPlanner.hpp:74-96)."""
        def one(tr):
            ts = jnp.linspace(0.0, 1.0, n_points + 1).astype(tr.duration.dtype) * tr.duration
            q, v, a = jax.vmap(tr.at_time)(ts)
            tau = jax.vmap(lambda a_, b_, c_: rnea.rnea(self.model, a_, b_, c_))(q, v, a)
            return ts, q, v, a, tau

        return jax.vmap(one)(traj) if traj.duration.ndim else one(traj)
