"""chip_smoke.py's checks, exercised on the CPU at tiny sizes, and the
refusal of the measurement paths to run without a GPU."""

import json
import pathlib
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_device_check_raises_without_gpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device()


def test_headline_refuses_cpu_without_fallback():
    from mpc_motion_planner_tpu.bench import headline

    with pytest.raises(RuntimeError, match="no GPU"):
        headline.main(batch=2, repeats=1)


def test_last_line_format():
    line = json.loads(chip_smoke.last_line())
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == len(jax.devices())


def _write_trajectory(path, a_jitter=0.0):
    """A 29-column file with an exact constant-acceleration MPC block."""
    t = np.linspace(0.0, 1.0, 201)
    a0 = np.linspace(-1.0, 1.0, 7)
    v0 = np.linspace(0.5, -0.5, 7)
    q = v0 * t[:, None] + 0.5 * a0 * t[:, None] ** 2
    v = v0 + a0 * t[:, None]
    a = np.tile(a0, (201, 1)) + a_jitter * np.sin(40 * t)[:, None]
    block = np.concatenate([t[:, None], q, v, a, np.zeros((201, 7))], axis=1)
    target = np.concatenate([[0.0], q[-1], v[-1], np.zeros(14)])
    np.savetxt(path, np.vstack([target[None], block, block]))


def test_submit_keeps_the_callers_precision():
    """A pool thread traces with the caller's float64 setting, not the
    process default (the test session runs with x64 on)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax.numpy as jnp

    assert jax.config.jax_enable_x64
    with ThreadPoolExecutor(1) as pool:
        with jax.enable_x64(False):
            got = chip_smoke.submit(pool, lambda: jnp.zeros(()).dtype).result()
        default = pool.submit(lambda: jnp.zeros(()).dtype).result()
    assert got == jnp.float32 and default == jnp.float64


def test_device_parity_phase_tiny_in_float32():
    """The GPU-vs-CPU phase at B=2 and a cut budget, in float32 inside an
    x64 session (as the gpu-marked tests run it): both arms agree."""
    with jax.enable_x64(False):
        figures = chip_smoke.device_parity_phase(batch=2, max_iter=50, check_every=10)
    assert figures["tol_hit_mismatches"] == 0
    assert figures["tf_share_within"] == 1.0


def test_reintegrate_consistent_file(tmp_path):
    path = tmp_path / "sol.txt"
    _write_trajectory(path)
    v_cons, q_err = chip_smoke.reintegrate(path)
    assert v_cons < 1e-9 and q_err < 1e-12


def test_reintegrate_flags_inconsistent_accelerations(tmp_path):
    path = tmp_path / "sol.txt"
    _write_trajectory(path, a_jitter=1.0)
    v_cons, _ = chip_smoke.reintegrate(path)
    assert v_cons > chip_smoke.OFFLINE_TOL["v_consistency"]


def test_compare_outcomes():
    tf = np.linspace(1.0, 2.0, 100)
    hit = np.ones(100, bool)
    conv = np.ones((100, 2), bool)
    figures, ok = chip_smoke.compare_outcomes((tf, hit, conv), (tf * (1 + 1e-4), hit, conv))
    assert ok and figures["tf_share_within"] == 1.0
    # more than 5% of t_f off by more than 1e-3 relative
    tf_bad = tf.copy()
    tf_bad[:6] *= 1.01
    assert not chip_smoke.compare_outcomes((tf_bad, hit, conv), (tf, hit, conv))[1]
    # a tol_hit difference
    hit_bad = hit.copy()
    hit_bad[0] = False
    assert not chip_smoke.compare_outcomes((tf, hit_bad, conv), (tf, hit, conv))[1]


def test_acceptance_gates_on_committed_artifact():
    """The gates pass on the committed float32 acceptance artifact and
    fail when a gate is broken."""
    from mpc_motion_planner_tpu.bench.analysis import (
        accuracy_stats,
        violation_counts_reference,
    )
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    path = ROOT / "analysis" / "benchmark_data_r05.txt.gz"
    rec = np.loadtxt(path)
    planner = MotionPlanner(margins=Margins(*chip_smoke.MARGINS))
    summary = {
        "reference": violation_counts_reference(rec, planner.limits),
        "accuracy": accuracy_stats(rec),
        "qp_conv_rate": 0.997,
    }
    gates = chip_smoke.acceptance_gates(summary)
    assert all(gates.values()), gates
    assert summary["reference"]["mpc"]["total"] == chip_smoke.ARTIFACT_TOTALS["mpc"]
    summary["qp_conv_rate"] = 0.9
    assert not all(chip_smoke.acceptance_gates(summary).values())


def test_qp_parity_phase_tiny():
    """The structured-vs-dense parity phase at B=2 and a cut budget: the
    float64 pair meets the CPU parity test's tolerances."""
    f64, ok64, f32, _ = chip_smoke.qp_parity(batch=2, max_iter=50, check_every=10)
    assert ok64
    assert f64["converged_flags_equal"]
    assert f64["iterations_max_abs_diff"] <= chip_smoke.QP_PARITY_TOL["iterations_atol"]
    assert f32["finite"]


def _f32_pair(conv, conv_ref, x_shift=0.0):
    """Two solutions of three 1-variable QPs min 0.5 x^2 - x, hard row
    0 <= x <= 2, soft box [0, 0.5] with weight 1 (optimum 0.5)."""
    from types import SimpleNamespace

    b = 3
    data = {
        "A": np.ones((b, 1, 1)), "P": np.ones((b, 1)), "q": -np.ones((b, 1)),
        "lc": np.zeros((b, 1)), "uc": 2 * np.ones((b, 1)),
        "lx": np.zeros((b, 1)), "ux": 0.5 * np.ones((b, 1)),
        "soft_c": np.zeros((b, 1)), "soft_x": np.ones((b, 1)),
    }
    x = np.full((b, 1), 0.5)
    got = SimpleNamespace(x=x + x_shift, converged=np.array(conv))
    ref = SimpleNamespace(x=x, converged=np.array(conv_ref))
    return got, ref, data


@pytest.mark.parametrize(
    "conv, conv_ref, x_shift, ok",
    [
        ([True, True, True], [True, True, True], 0.0, True),
        ([True, True, True], [True, True, True], 1e-3, True),
        # x = 0.1: feasible, objective -0.095 against the optimum's -0.375
        ([True, True, True], [True, True, True], -0.4, False),
        # x = 3: the hard row x <= 2 is violated
        ([True, True, True], [True, True, True], 2.5, False),
        # converged where the reference did not
        ([True, True, True], [True, True, False], 0.0, False),
        # reference below its convergence floor
        ([False, False, False], [False, False, False], 0.0, False),
    ],
)
def test_compare_qp_f32(conv, conv_ref, x_shift, ok):
    figures, verdict = chip_smoke.compare_qp_f32(*_f32_pair(conv, conv_ref, x_shift))
    assert verdict is ok
    if all(conv) and all(conv_ref):
        assert figures["converged_only_structured"] == 0
        assert figures["flag_mismatch_share"] == 0.0
