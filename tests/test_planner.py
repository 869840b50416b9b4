import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.ops.qp import QPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner


@pytest.fixture(scope="module")
def planner():
    return MotionPlanner(margins=Margins(0.9, 0.9, 0.5, 0.9, 0.1))


@pytest.fixture(scope="module")
def solved(planner):
    """One easy, well-conditioned solve pair (rest-to-rest, modest move)."""
    q0 = jnp.asarray([0.0, -0.5, 0.0, -2.0, 0.0, 1.6, 0.0])
    q1 = q0 + jnp.asarray([0.4, 0.2, -0.3, 0.3, 0.2, -0.2, 0.5])
    cur = jnp.concatenate([q0, jnp.zeros(7)])[None]
    tgt = jnp.concatenate([q1, jnp.zeros(7)])[None]
    return cur, tgt, planner.solve(cur, tgt)


def test_solution_reaches_target(planner, solved):
    cur, tgt, sol = solved
    X, U, p = sol.states()
    # l1 over all 488 rows; the elastic height slacks (SQPSettings.
    # slack_penalty) trade a slightly looser feasible-case residual for a
    # 5x better worst case, hence 1e-1 rather than 5e-2
    assert float(sol.violation[0]) < 1e-1
    # terminal box is +-1e-2 per joint (motionPlanner.hpp:44)
    np.testing.assert_allclose(np.asarray(X[0, -1]), np.asarray(tgt[0]), atol=1.2e-2)
    np.testing.assert_allclose(np.asarray(X[0, 0]), np.asarray(cur[0]), atol=1e-9)
    assert 0.1 < float(p[0]) < 10.0


def test_minimum_time_beats_warm_start(planner, solved):
    """t_f at (or below) the jerk-limited OTG duration. With the C1
    Gauss–Lobatto transcription and a tight acceleration margin the OTG is
    already near-optimal for modest moves, so parity + 5% is the bound."""
    _, _, sol = solved
    assert float(sol.final_time[0]) <= float(sol.warm_start.duration[0]) * 1.05
    assert float(sol.final_time[0]) >= float(sol.warm_start.duration[0]) * 0.2


def test_solution_respects_limits(planner, solved):
    _, tgt, sol = solved
    time, q, qd, qdd, tau = sol.sample(200)
    m = planner.margins
    lim = planner.limits
    tol = 0.08  # interpolation/QP-tolerance slack
    assert np.all(np.abs(np.asarray(qd)) <= np.asarray(m.velocity * lim.max_velocity) + tol)
    assert np.all(np.abs(np.asarray(tau)) <= np.asarray(m.torque * lim.max_torque) + 1.0)
    # monotone time, de-normalized by t_f
    t = np.asarray(time[0])
    assert t[0] == 0 and np.all(np.diff(t) > 0)
    assert t[-1] == pytest.approx(float(sol.final_time[0]))


def test_dynamics_consistency(planner, solved):
    """Independent re-simulation: integrate the sampled accelerations and
    compare with the sampled velocities (trapezoid)."""
    _, _, sol = solved
    time, q, qd, qdd, _ = sol.sample(400)
    t, v, a = np.asarray(time[0]), np.asarray(qd[0]), np.asarray(qdd[0])
    dt = np.diff(t)[:, None]
    v_int = v[0] + np.cumsum(0.5 * (a[1:] + a[:-1]) * dt, axis=0)
    assert np.max(np.abs(v_int - v[1:])) < 5e-2


def test_reseed_guess(planner, solved):
    cur, tgt, sol = solved
    z = sol.reseed_guess(cur, tgt)
    np.testing.assert_allclose(np.asarray(z[0, :14]), np.asarray(cur[0]), atol=0)
    np.testing.assert_allclose(
        np.asarray(z[0, 18 * 14 : 19 * 14]), np.asarray(tgt[0]), atol=0
    )
    # a hot restart from the reseed stays in the easy problem's quality
    # band (absolute bound: relative-to-fresh comparisons are noise when
    # both violations are ~1e-2 — the r05 ruiz default change improved
    # the fresh solve 2x and broke the old 2x-relative form)
    sol2 = planner.solve(cur, tgt, z0=z)
    assert float(sol2.violation[0]) < 0.2
    X2, _, _ = sol2.states()
    np.testing.assert_allclose(np.asarray(X2[0, -1]), np.asarray(tgt[0]), atol=1.2e-2)


def test_check_state_in_bounds(planner):
    lim = planner.limits
    mid = (lim.min_position + lim.max_position) / 2
    ok = jnp.zeros(7)
    assert int(planner.check_state_in_bounds(mid, ok)) == 0
    assert int(planner.check_state_in_bounds(lim.max_position + 1.0, ok)) == 1
    assert int(planner.check_state_in_bounds(mid, lim.max_velocity * 2)) == 2
    assert int(planner.check_state_in_bounds(lim.max_position + 1, lim.max_velocity * 2)) == 3
    assert int(planner.check_state_in_bounds(mid, ok, lim.max_acceleration * 2)) == 10


def test_sample_random_state(planner):
    q, v = planner.sample_random_state(jax.random.PRNGKey(3), (32,))
    lo, hi = planner.position_bounds()
    assert np.all(np.asarray(q) >= np.asarray(lo) - 1e-12)
    assert np.all(np.asarray(q) <= np.asarray(hi) + 1e-12)
    vmax = planner.margins.velocity * planner.limits.max_velocity
    assert np.all(np.abs(np.asarray(v)) <= np.asarray(vmax))
    # rejection criterion: joint-7 placement height >= min_height
    from mpc_motion_planner_tpu.ops.kinematics import fk

    for k in range(32):
        _, p = fk(planner.model, q[k])
        assert float(p[6, 2]) >= planner.limits.min_height


def test_float32_solve_matches_float64(planner, solved):
    """The shipping path runs f32; the solve must stay usable at f32."""
    cur, tgt, sol64 = solved
    p32 = MotionPlanner(margins=Margins(0.9, 0.9, 0.5, 0.9, 0.1), dtype=jnp.float32)
    sol32 = p32.solve(cur.astype(jnp.float32), tgt.astype(jnp.float32))
    X32, _, _ = sol32.states()
    np.testing.assert_allclose(np.asarray(X32[0, -1]), np.asarray(tgt[0]), atol=2e-2)
    assert abs(float(sol32.final_time[0]) - float(sol64.final_time[0])) < 0.1
    assert float(sol32.violation[0]) < 0.2


def test_warm_start_from_trajectory(planner, solved):
    """Generic warm start (motionPlanner.hpp:145-172): seeding from the
    sampled solution must reproduce the node states at nearest samples."""
    cur, tgt, sol = solved
    time, q, qd, qdd, _ = sol.sample(200)
    tf = sol.final_time
    z0 = planner.warm_start_from_trajectory(tf, q, qd, qdd)
    assert z0.shape == (1, planner.ocp.num_var)
    X, U, p = planner.ocp.unpack(z0)
    assert float(p[0]) == pytest.approx(float(tf[0]))
    # node 0 / node 18 match the sampled endpoints
    np.testing.assert_allclose(np.asarray(X[0, 0, :7]), np.asarray(q[0, 0]), atol=0)
    np.testing.assert_allclose(np.asarray(X[0, -1, :7]), np.asarray(q[0, -1]), atol=0)


def test_point_queries(planner, solved):
    cur, tgt, sol = solved
    t_mid = sol.final_time * 0.5
    q, v, a, tau = planner.solution_point(sol, t_mid)
    assert q.shape == (1, 7) and tau.shape == (1, 7)
    # beyond-duration clamps to the final state
    q_end, v_end, _, _ = planner.solution_point(sol, sol.final_time + 5.0)
    np.testing.assert_allclose(np.asarray(q_end[0]), np.asarray(tgt[0, :7]), atol=1.5e-2)
    qr, vr, ar, taur = planner.warm_start_point(sol.warm_start, t_mid)
    assert qr.shape == (1, 7)


def test_set_min_height(planner):
    planner2 = MotionPlanner(margins=Margins(0.9, 0.9, 0.5, 0.9, 0.1))
    lo, hi = planner2.ineq_bounds()
    assert float(lo[-1]) == pytest.approx(0.05)
    planner2.set_min_height(0.2)
    lo, hi = planner2.ineq_bounds()
    assert float(lo[-1]) == pytest.approx(0.2)


def test_ik_random_start(planner):
    q_true = jnp.asarray([0.3, -0.4, 0.2, -1.8, 0.1, 1.9, 0.4])
    from mpc_motion_planner_tpu.ops.kinematics import frame_placement

    R, p = frame_placement(planner.model, q_true, planner._tool)
    q_sol, ok = planner.inverse_kinematics(R, p, key=jax.random.PRNGKey(7), max_iters=600)
    R2, p2 = frame_placement(planner.model, q_sol, planner._tool)
    if bool(ok):  # random starts can fail on hard poses; converged must match
        np.testing.assert_allclose(np.asarray(p2), np.asarray(p), atol=1e-3)


def test_hot_restart_solve(planner, solved):
    """solve(z0=...) — the hot-restart path (solve_trajectory(false),
    motionPlanner.cpp:177-208): skips OTG planning (warm_start is None),
    converges at least as fast as the fresh solve it restarts from, and
    the re-used boundary pins hold exactly."""
    cur, tgt, sol = solved
    z0 = sol.reseed_guess(cur, tgt)
    hot = planner.solve(cur, tgt, z0=z0, lam_c0=sol.lam_c, lam_x0=sol.lam_x)
    assert hot.warm_start is None
    X, _, _ = hot.states()
    np.testing.assert_allclose(np.asarray(X[0, 0]), np.asarray(cur[0]), atol=1e-9)
    np.testing.assert_allclose(np.asarray(X[0, -1]), np.asarray(tgt[0]), atol=1.2e-2)
    # restarting from a solved iterate: quality stays in the easy
    # problem's band (absolute bound — see test_reseed_guess) and the QP
    # work does not grow
    assert float(hot.violation[0]) < 0.2
    assert int(np.asarray(hot.qp_iterations).sum()) <= int(
        np.asarray(sol.qp_iterations).sum()
    )


def test_hot_restart_receding_horizon(planner, solved):
    """The hot-restart use case the reseed exists for
    (motionPlanner.cpp:199-207): the TARGET stays fixed and the start
    advances along the previous solution — the previous trajectory is
    then an excellent guess and every hot solve converges with good
    quality and a shrinking time-to-go. (Re-seeding across a CHANGED
    target is measured WORSE than a fresh OTG warm start —
    KERNELS.md, hot restarts, negative-result arm — so
    this receding pattern is the supported hot path.)"""
    cur, tgt, sol = solved
    t_prev = float(sol.final_time[0])
    for _ in range(3):
        # advance the start 10% of the remaining horizon along the solution
        cur = sol.x_at(jnp.asarray(0.1, sol.z.dtype))
        sol = planner.solve(
            cur, tgt, z0=sol.reseed_guess(cur, tgt),
            lam_c0=sol.lam_c, lam_x0=sol.lam_x,
        )
        assert sol.warm_start is None
        X, _, _ = sol.states()
        np.testing.assert_allclose(
            np.asarray(X[0, -1]), np.asarray(tgt[0]), atol=1.2e-2
        )
        assert float(sol.violation[0]) < 1e-1
        assert bool(np.all(np.asarray(sol.qp_converged)))
        # minimum time shrinks as the start closes on the target
        t_now = float(sol.final_time[0])
        assert t_now <= t_prev * 1.02
        t_prev = t_now


def test_per_step_qp_schedules(planner, solved):
    """SQPSettings.qp_step_schedules gives each SQP iteration its own
    ADMM budget: step i's QP runs with max_iter = that entry. The step-1
    QP is dual-warm-started on a nearly unchanged linearization and needs
    measurably fewer iterations (p50 125 vs 175 on the chained workload,
    KERNELS.md), so a shorter step-1 budget must not change the solution
    on an easy problem — and the budget cap must actually bind."""
    cur, tgt, sol = solved
    stepped = MotionPlanner(
        margins=planner.margins,
        qp_settings=planner.qp_settings,
        sqp_settings=SQPSettings(qp_step_schedules="700;500"),
    )
    sol2 = stepped.solve(cur, tgt)
    # the easy problem converges inside both budgets -> same solution
    np.testing.assert_allclose(
        np.asarray(sol2.z), np.asarray(sol.z), rtol=0, atol=5e-3
    )
    assert bool(np.all(np.asarray(sol2.qp_converged)))

    # a deliberately tiny step-1 budget must actually bind the cap
    capped = MotionPlanner(
        margins=planner.margins,
        qp_settings=planner.qp_settings,
        sqp_settings=SQPSettings(qp_step_schedules="700;50"),
    )
    it = np.asarray(capped.solve(cur, tgt).qp_iterations)
    assert it.shape[-1] == 2
    assert int(it[..., 1].max()) <= 50
