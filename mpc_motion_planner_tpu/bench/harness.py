"""Benchmark harness: reference-parity scenario generation, validation and
record schema.

Reproduces the semantics of /root/reference/examples/benchmark.cpp:

* Scenario chain: iteration i's start state is iteration i-1's target
  (the current state is never reset, benchmark.cpp:50-53); targets are
  rejection-sampled configurations with task-space-derived joint
  velocities (zero angular component) clamped to task and joint limits
  (benchmark.cpp:19-42).
* Post-hoc validation at 201 samples per trajectory, independent of the
  solver: finite-difference jerk vs 10x the full jerk limit
  (benchmark.cpp:86-93), cartesian linear/angular speed limits
  (benchmark.cpp:96-105), table collision z < 0 (benchmark.cpp:107-114).
* The 162-column record layout of benchmark.cpp:163-194 (min/max of the
  28 trajectory rows for both planners, final-state errors, pass flags,
  target state) so the reference's benchmark_analysis notebook semantics
  apply unchanged.

The batched difference: the 1000-iteration serial loop becomes one
batched solve — sampling the chain is sequential-free (all targets are
drawn first; starts are the shifted targets), so every solve runs
simultaneously.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import full_precision
from ..ops import kinematics
from ..planner import MotionPlanner, Solution

N_CHECK_POINTS = 200  # reference nPoints (benchmark.cpp:58)


@full_precision
def sample_benchmark_targets(planner: MotionPlanner, key, num: int):
    """Batched target (position, velocity) sampling per benchmark.cpp:19-42."""
    k_q, k_v = jax.random.split(key)
    q, _ = planner.sample_random_state(k_q, (num,))

    # target velocity: damped-pseudo-inverse of a random cartesian linear
    # velocity in [-vmax_lin, vmax_lin]^3 with zero angular velocity
    v_cart = jax.random.uniform(
        k_v, (num, 3), q.dtype,
        -planner.limits.max_linear_velocity, planner.limits.max_linear_velocity,
    )
    zero3 = jnp.zeros(3, q.dtype)
    qd = jax.vmap(lambda qq, vv: planner.inverse_velocities(qq, vv, zero3))(q, v_cart)

    task = jax.vmap(planner.forward_velocities)(q, qd)
    lin = jnp.linalg.norm(task[:, :3], axis=-1)
    ang = jnp.linalg.norm(task[:, 3:], axis=-1)

    # clamp task-space speeds (0.9 back-off, benchmark.cpp:25-38)
    scale = jnp.where(
        lin > planner.limits.max_linear_velocity,
        0.9 * planner.limits.max_linear_velocity / lin,
        1.0,
    )
    qd = qd * scale[:, None]
    task = jax.vmap(planner.forward_velocities)(q, qd)
    ang = jnp.linalg.norm(task[:, 3:], axis=-1)
    scale = jnp.where(
        ang > planner.limits.max_angular_velocity,
        0.9 * planner.limits.max_angular_velocity / ang,
        1.0,
    )
    qd = qd * scale[:, None]

    # clamp joint velocities (1.1 back-off, benchmark.cpp:40-42)
    vmax = planner.margins.velocity * planner.limits.max_velocity
    ratio = jnp.max(jnp.abs(qd) / vmax, axis=-1)
    qd = jnp.where(ratio[:, None] > 1.0, qd / (1.1 * ratio[:, None]), qd)
    return q, qd


@partial(jax.jit, static_argnums=(0, 2))
@full_precision
def chain_states(planner: MotionPlanner, key, num: int):
    """Build the benchmark's receding chain: start_i = target_{i-1};
    start_0 is the mid-range default configuration (motionPlanner.cpp:5-8).
    Jitted as one program (the planner and `num` are static)."""
    q_t, qd_t = sample_benchmark_targets(planner, key, num)
    default_q = (planner.limits.max_position + planner.limits.min_position) / 2.0
    q_s = jnp.concatenate([default_q[None, :], q_t[:-1]], axis=0)
    qd_s = jnp.concatenate([jnp.zeros_like(qd_t[:1]), qd_t[:-1]], axis=0)
    current = jnp.concatenate([q_s, qd_s], axis=-1)
    target = jnp.concatenate([q_t, qd_t], axis=-1)
    return current, target


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrajectoryChecks:
    """Per-trajectory pass flags (1 = pass), reference encoding."""

    jerk: jax.Array
    linear_velocity: jax.Array
    angular_velocity: jax.Array
    collision: jax.Array


@full_precision
def validate_trajectory(planner: MotionPlanner, time, q, qd, qdd):
    """Independent re-simulation checks (benchmark.cpp:82-160).

    Inputs are (B, N+1, nq) sampled trajectories with (B, N+1) times.
    """
    jerk_limit = 10.0 * planner.limits.max_jerk  # 10x full limit, :89
    dT = (time[:, -1] - time[:, 0]) / (time.shape[1] - 1)
    jerk = (qdd[:, 1:] - qdd[:, :-1]) / jnp.maximum(dT, 1e-9)[:, None, None]
    jerk_ok = jnp.all(jnp.abs(jerk) <= jerk_limit, axis=(1, 2))

    task = jax.vmap(jax.vmap(planner.forward_velocities))(q, qd)
    lin_ok = jnp.all(
        jnp.linalg.norm(task[..., :3], axis=-1) <= planner.limits.max_linear_velocity,
        axis=-1,
    )
    ang_ok = jnp.all(
        jnp.linalg.norm(task[..., 3:], axis=-1) <= planner.limits.max_angular_velocity,
        axis=-1,
    )

    tool = planner.model.frame("panda_tool")
    height = jax.vmap(
        jax.vmap(lambda qq: kinematics.frame_height(planner.model, qq, tool))
    )(q)
    col_ok = jnp.all(height >= 0.0, axis=-1)  # z < 0 is a table hit, :110

    to_i = lambda b: b.astype(jnp.int32)
    return TrajectoryChecks(to_i(jerk_ok), to_i(lin_ok), to_i(ang_ok), to_i(col_ok))


def _traj_extrema(time, q, qd, qdd, tau):
    """(min, max) over the 28 non-time rows of the 29-row trajectory matrix
    (benchmark.cpp:75-79 layout: q, qd, qdd, tau)."""
    rows = jnp.concatenate([q, qd, qdd, tau], axis=-1)  # (B, N+1, 28)
    return jnp.min(rows, axis=1), jnp.max(rows, axis=1)


@full_precision
def benchmark_records(
    planner: MotionPlanner,
    solution: Solution,
    target,
    n_points: int = N_CHECK_POINTS,
    warm_start=None,
):
    """Assemble the 162-column benchmark rows + checks for a solved batch.

    Returns (records (B, 162), checks_rk, checks_mpc), with the exact
    column layout of benchmark.cpp:163-194. The OTG baseline columns come
    from the trajectory that actually seeded the solve; hot-restart
    solutions (solve(z0=...)) carry none, so the caller must pass the
    `warm_start` trajectory to compare against explicitly.
    """
    nq = planner.ocp.nq

    traj = solution.warm_start if warm_start is None else warm_start
    if traj is None:
        raise ValueError(
            "solution has no OTG warm start (hot-restart solve); pass "
            "benchmark_records(..., warm_start=<JerkLimitedTrajectory>) to "
            "choose the baseline trajectory for the RK columns"
        )
    t_rk, q_rk, qd_rk, qdd_rk, tau_rk = planner.sample_warm_start(
        traj, n_points
    )
    t_mpc, q_mpc, qd_mpc, qdd_mpc, tau_mpc = solution.sample(n_points)

    checks_rk = validate_trajectory(planner, t_rk, q_rk, qd_rk, qdd_rk)
    checks_mpc = validate_trajectory(planner, t_mpc, q_mpc, qd_mpc, qdd_mpc)

    min_rk, max_rk = _traj_extrema(t_rk, q_rk, qd_rk, qdd_rk, tau_rk)
    min_mpc, max_mpc = _traj_extrema(t_mpc, q_mpc, qd_mpc, qdd_mpc, tau_mpc)

    err_rk = jnp.concatenate(
        [q_rk[:, -1] - target[:, :nq], qd_rk[:, -1] - target[:, nq:]], axis=-1
    )
    err_mpc = jnp.concatenate(
        [q_mpc[:, -1] - target[:, :nq], qd_mpc[:, -1] - target[:, nq:]], axis=-1
    )

    flags = jnp.stack(
        [
            checks_rk.jerk,
            checks_rk.linear_velocity,
            checks_rk.angular_velocity,
            checks_rk.collision,
            checks_mpc.jerk,
            checks_mpc.linear_velocity,
            checks_mpc.angular_velocity,
            checks_mpc.collision,
        ],
        axis=-1,
    ).astype(min_rk.dtype)

    records = jnp.concatenate(
        [min_rk, max_rk, min_mpc, max_mpc, err_rk, err_mpc, flags, target],
        axis=-1,
    )
    return records, checks_rk, checks_mpc
