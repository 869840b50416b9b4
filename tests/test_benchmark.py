import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.bench.analysis import (
    accuracy_stats,
    decode,
    violation_counts,
)
from mpc_motion_planner_tpu.bench.harness import (
    benchmark_records,
    chain_states,
    sample_benchmark_targets,
    validate_trajectory,
)
from mpc_motion_planner_tpu.ops.qp import QPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner


@pytest.fixture(scope="module")
def planner():
    return MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1))


def test_sample_benchmark_targets(planner):
    q, qd = sample_benchmark_targets(planner, jax.random.PRNGKey(0), 16)
    assert q.shape == (16, 7) and qd.shape == (16, 7)
    vmax = planner.margins.velocity * planner.limits.max_velocity
    assert np.all(np.abs(np.asarray(qd)) <= np.asarray(vmax) + 1e-9)
    # task-space speeds respect the cartesian caps after clamping
    task = jax.vmap(planner.forward_velocities)(q, qd)
    lin = np.linalg.norm(np.asarray(task[:, :3]), axis=-1)
    ang = np.linalg.norm(np.asarray(task[:, 3:]), axis=-1)
    assert np.all(lin <= planner.limits.max_linear_velocity + 1e-6)
    assert np.all(ang <= planner.limits.max_angular_velocity + 1e-6)


def test_chain_states(planner):
    cur, tgt = chain_states(planner, jax.random.PRNGKey(1), 10)
    assert cur.shape == (10, 14) and tgt.shape == (10, 14)
    # the chain: start_i = target_{i-1} (benchmark.cpp never resets current)
    np.testing.assert_allclose(np.asarray(cur[1:]), np.asarray(tgt[:-1]), atol=0)
    # first start: mid-range default at rest (motionPlanner.cpp:5-8)
    mid = (planner.limits.max_position + planner.limits.min_position) / 2
    np.testing.assert_allclose(np.asarray(cur[0, :7]), np.asarray(mid), atol=1e-12)
    np.testing.assert_allclose(np.asarray(cur[0, 7:]), 0, atol=0)


def test_validate_trajectory_flags(planner):
    # A resting trajectory passes everything
    B, N = 2, 50
    q = jnp.tile(jnp.asarray([0.0, -0.5, 0.0, -2.0, 0.0, 1.6, 0.0]), (B, N + 1, 1))
    zeros = jnp.zeros((B, N + 1, 7))
    time = jnp.tile(jnp.linspace(0, 1, N + 1)[None], (B, 1))
    checks = validate_trajectory(planner, time, q, zeros, zeros)
    assert np.all(np.asarray(checks.jerk) == 1)
    assert np.all(np.asarray(checks.collision) == 1)
    assert np.all(np.asarray(checks.linear_velocity) == 1)

    # A trajectory whose tool dips below the table trips the collision flag
    # tool height at this configuration is -0.198 m (below the table plane)
    q_low = q.at[0, 10].set(jnp.asarray([0.0, 1.5, 0.0, -1.0, 0.0, 1.5, 0.0]))
    checks2 = validate_trajectory(planner, time, q_low, zeros, zeros)
    assert int(checks2.collision[0]) == 0
    assert int(checks2.collision[1]) == 1


@pytest.fixture(scope="module")
def small_run(planner):
    cur, tgt = chain_states(planner, jax.random.PRNGKey(2), 4)
    sol = planner.solve(cur, tgt)
    rec, checks_rk, checks_mpc = benchmark_records(planner, sol, tgt)
    return cur, tgt, sol, rec, checks_rk, checks_mpc


def test_records_layout(small_run):
    cur, tgt, sol, rec, _, _ = small_run
    assert rec.shape == (4, 162)
    d = decode(np.asarray(rec))
    # target columns round-trip
    np.testing.assert_allclose(d["target"], np.asarray(tgt), atol=0)
    # extrema bracket: min <= max everywhere
    assert np.all(d["min_rk"] <= d["max_rk"] + 1e-12)
    assert np.all(d["min_mpc"] <= d["max_mpc"] + 1e-12)
    # flags are 0/1
    assert set(np.unique(d["flags"])) <= {0.0, 1.0}


def test_analysis_summaries(small_run, planner):
    *_, rec, _, _ = small_run
    counts = violation_counts(np.asarray(rec), planner.limits, planner.margins)
    assert set(counts) == {"ruckig", "mpc"}
    for c in counts.values():
        assert set(c) == {
            "position", "velocity", "acceleration", "torque",
            "jerk", "task_velocity", "collision",
        }
        assert all(0 <= v <= 4 for v in c.values())
    stats = accuracy_stats(np.asarray(rec))
    assert stats["ruckig"]["pos_err_p50"] < 0.3
    # box-hit fractions are labeled for exactly what they test: the hard
    # ±1e-2 box, and the box + QP tolerance the solver actually guarantees
    assert 0.0 <= stats["mpc"]["within_target_box"] <= 1.0
    assert (
        stats["mpc"]["within_target_box"]
        <= stats["mpc"]["within_box_plus_tol"]
    )
    # the inf-norm percentiles let the thresholds be read off the data
    assert (
        stats["mpc"]["err_inf_p50"]
        <= stats["mpc"]["err_inf_p95"]
        <= stats["mpc"]["err_inf_max"]
    )

    from mpc_motion_planner_tpu.bench.analysis import violation_magnitudes

    mags = violation_magnitudes(np.asarray(rec), planner.limits, planner.margins)
    for p in ("ruckig", "mpc"):
        for cat in ("position", "velocity", "acceleration", "torque"):
            s = mags[p][cat]
            assert 0.0 <= s["p50"] <= s["p99"] <= s["max"]
            assert s["rel_max"] >= 0.0
        # a category with zero violation count must have zero magnitude
        for cat in ("position", "velocity", "acceleration", "torque"):
            if counts[p][cat] == 0:
                assert mags[p][cat]["max"] <= 1e-6


def test_violation_counting_conventions(planner):
    """Pin the STRICT (margin-scaled) vs REFERENCE (notebook cell 3)
    counting conventions against hand-built records."""
    from mpc_motion_planner_tpu.bench.analysis import (
        violation_counts_reference,
    )

    lim = planner.limits
    n = 3
    rec = np.zeros((n, 162))
    # benign extrema: mid-position box, zero velocity/accel/torque
    mid = (np.asarray(lim.max_position) + np.asarray(lim.min_position)) / 2
    for sl in (slice(0, 28), slice(28, 56), slice(56, 84), slice(84, 112)):
        rec[:, sl.start : sl.start + 7] = mid
    rec[:, 140:148] = 1.0  # all flags pass

    # trajectory 0 (MPC planner): joint-3 velocity exceeds BOTH directions
    # of the FULL limit -> reference convention counts it TWICE for MPC
    vfull = float(np.asarray(lim.max_velocity)[2])
    rec[0, 56 + 7 + 2] = -vfull - 0.1  # min_mpc velocity row
    rec[0, 84 + 7 + 2] = vfull + 0.1  # max_mpc velocity row
    # trajectory 1 (MPC): acceleration over the MARGIN-scaled box but
    # inside the full limit -> strict counts it, reference does not
    afull = float(np.asarray(lim.max_acceleration)[0])
    rec[1, 84 + 14] = 0.8 * afull  # margin 0.6 -> scaled box is 0.6*afull
    # trajectory 2 (both planners): angular-velocity flag fails -> strict
    # task_velocity counts it, reference taskVelocity (flag[1:2]) does NOT
    rec[2, 140 + 2] = 0.0  # rk angular flag
    rec[2, 144 + 2] = 0.0  # mpc angular flag

    strict = violation_counts(rec, lim, planner.margins)
    ref = violation_counts_reference(rec, lim)

    assert strict["mpc"]["velocity"] == 1
    assert ref["mpc"]["velocity_fails"] == 2  # sum convention counts twice
    assert strict["mpc"]["acceleration"] == 1  # margin-scaled box
    assert ref["mpc"]["torqueAccel_fails"] == 0  # full limit not exceeded
    assert strict["mpc"]["task_velocity"] == 1  # angular OR linear
    assert ref["mpc"]["taskVelocity_fails"] == 0  # linear flag only
    assert ref["ruckig"]["taskVelocity_fails"] == 0
    assert ref["mpc"]["total"] == 2
    assert ref["ruckig"]["total"] == 0

    # Ruckig OR-convention: the same double-sided exceedance counts once
    rec2 = rec.copy()
    rec2[0, 0 + 7 + 2] = -vfull - 0.1  # min_rk velocity
    rec2[0, 28 + 7 + 2] = vfull + 0.1  # max_rk velocity
    ref2 = violation_counts_reference(rec2, lim)
    assert ref2["ruckig"]["velocity_fails"] == 1
    assert ref2["mpc"]["velocity_fails"] == 2


def test_reference_limits_match_notebook(planner):
    """The full PandaLimits equal the notebook's hard-coded limit arrays
    (benchmark_analysis.ipynb cell 1) that violation_counts_reference
    compares against."""
    lim = planner.limits
    np.testing.assert_allclose(
        np.asarray(lim.min_position),
        [-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973],
    )
    np.testing.assert_allclose(
        np.asarray(lim.max_position),
        [2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973],
    )
    np.testing.assert_allclose(
        np.asarray(lim.max_velocity),
        [2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61],
    )
    np.testing.assert_allclose(
        np.asarray(lim.max_acceleration), [15.0, 7.5, 10.0, 12.5, 15.0, 20.0, 20.0]
    )
    np.testing.assert_allclose(
        np.asarray(lim.max_torque), [87, 87, 87, 87, 12, 12, 12]
    )


def test_io_roundtrip(tmp_path, small_run):
    from mpc_motion_planner_tpu.utils.io import (
        read_benchmark_records,
        write_benchmark_records,
    )

    *_, rec, _, _ = small_run
    path = tmp_path / "bench.txt"
    write_benchmark_records(path, np.asarray(rec[:2]))
    write_benchmark_records(path, np.asarray(rec[2:]))  # append mode
    back = read_benchmark_records(path)
    np.testing.assert_allclose(back, np.asarray(rec), rtol=1e-6)


def test_optimal_solution_format(tmp_path, planner, small_run):
    from mpc_motion_planner_tpu.utils.io import write_optimal_solution

    cur, tgt, sol, *_ = small_run
    rk = planner.sample_warm_start(sol.warm_start, 200)
    mpc = sol.sample(200)
    unb = lambda tup: tuple(np.asarray(x[0]) for x in tup)
    path = tmp_path / "optimal_solution.txt"
    write_optimal_solution(path, np.asarray(tgt[0]), unb(rk), unb(mpc))
    data = np.loadtxt(path)
    assert data.shape == (1 + 201 + 201, 29)
    np.testing.assert_allclose(data[0, 1:15], np.asarray(tgt[0]), atol=1e-6)


def test_committed_acceptance_artifact_matches_results_md(planner):
    """RESULTS.md's headline numbers are re-derivable from the committed
    acceptance artifact — pins doc/artifact consistency so a regenerated
    artifact or an analysis-code change cannot silently desynchronize the
    two. (Artifact: analysis/benchmark_data_r05.txt.gz, a float32 record
    of solver outputs, not of speed: 1000 trajectories at the shipping
    defaults, taken on an earlier accelerator.)"""
    import pathlib

    from mpc_motion_planner_tpu.bench.analysis import (
        accuracy_stats,
        violation_counts_reference,
    )

    path = (
        pathlib.Path(__file__).resolve().parents[1]
        / "analysis" / "benchmark_data_r05.txt.gz"
    )
    if not path.exists():
        pytest.skip("acceptance artifact not present")
    rec = np.loadtxt(path)
    assert rec.shape == (1000, 162)

    acc_planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1))
    ref = violation_counts_reference(rec, acc_planner.limits)
    # RESULTS.md "reference convention" table
    assert ref["mpc"]["position_fails"] == 0
    assert ref["mpc"]["velocity_fails"] == 0
    assert ref["mpc"]["torqueAccel_fails"] == 0
    assert ref["mpc"]["Jerk_fails"] == 0
    assert ref["mpc"]["total"] == 267
    assert ref["ruckig"]["total"] == 290

    acc = accuracy_stats(rec)
    # 100% inside the +-(1e-2 + eps_abs) box; final states sit ON the
    # terminal-box boundary to f32 rounding
    assert acc["mpc"]["within_box_plus_tol"] == 1.0
    assert acc["mpc"]["err_inf_max"] <= 1e-2 + 1e-6
    assert acc["ruckig"]["within_target_box"] == 1.0
