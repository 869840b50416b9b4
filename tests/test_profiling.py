"""Smoke test for the profiling subsystem."""

import jax

from mpc_motion_planner_tpu.ops.qp import QPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner
from mpc_motion_planner_tpu.utils.profiling import (
    loop_kernel_summary,
    stage_timings,
    stage_timings_structured,
    time_fn,
    trace,
    trace_events,
)


def test_stage_timings_smoke():
    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        sqp_settings=SQPSettings(max_iter=1),
        qp_settings=QPSettings(max_iter=30, check_every=10, rho_update_every=0),
    )
    cur = jax.numpy.tile(
        jax.numpy.concatenate(
            [
                (planner.limits.max_position + planner.limits.min_position) / 2.0,
                jax.numpy.zeros(7, planner.limits.max_position.dtype),
            ]
        )[None],
        (2, 1),
    )
    tgt = cur + 0.1
    out = stage_timings(planner, cur, tgt, repeats=1)
    for stage in ("warm_start", "linearize", "qp", "line_search", "total"):
        assert out[stage]["median_s"] > 0.0
    assert out["batch"] == 2
    assert out["solves_per_s"] > 0.0


def test_stage_timings_structured_smoke(tmp_path):
    """Shipping-path decomposition runs and accounts for every stage
    (the structured backend, as on the GPU), and its traced QP call is
    attributed to the ADMM loop."""
    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        sqp_settings=SQPSettings(max_iter=1),
        qp_settings=QPSettings(
            max_iter=30, check_every=10, rho_update_every=0,
            backend="structured", kkt_refine=0,
        ),
    )
    cur = jax.numpy.tile(
        jax.numpy.concatenate(
            [
                (planner.limits.max_position + planner.limits.min_position) / 2.0,
                jax.numpy.zeros(7, planner.limits.max_position.dtype),
            ]
        )[None],
        (2, 1),
    )
    tgt = cur + 0.1
    out = stage_timings_structured(planner, cur, tgt, repeats=1, trace_dir=str(tmp_path))
    for stage in (
        "warm_start", "linearize", "ruiz", "assemble_banded", "factor",
        "qp", "line_search", "total",
    ):
        assert out[stage]["median_s"] > 0.0
    assert out["admm_loop_derived_s"] >= 0.0
    assert out["batch"] == 2
    qp_trace = out["qp_trace"]
    assert qp_trace["trips"] == 30
    assert qp_trace["kernels_per_iteration"] >= 1.0
    assert 0.0 < qp_trace["device_busy_share"] <= 1.0


def test_time_fn():
    f = jax.jit(lambda x: x * 2.0)
    stats = time_fn(f, jax.numpy.ones(8), repeats=2)
    assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]


def test_trace_events_attribute_a_loop(tmp_path):
    """A traced 7-trip loop: its ops ran 7 times each and are the loop's;
    the ops around it are not."""
    body = lambda i, y: jax.numpy.sin(y) @ y
    f = jax.jit(lambda x: jax.lax.fori_loop(0, 7, body, x))
    x = jax.numpy.ones((32, 32))
    jax.block_until_ready(f(x))
    with trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    events = trace_events(str(tmp_path))
    summary = loop_kernel_summary(events, trips=7)
    assert summary["kernel_names_in_loop"] >= 2
    assert summary["kernels_per_iteration"] == int(summary["kernels_per_iteration"])
    assert summary["kernels_outside_loop"] >= 1
    assert 0.0 < summary["device_busy_share"] <= 1.0


def test_loop_kernel_summary_counts():
    # two loop kernels per trip over 3 trips, one kernel before the loop
    # and one nested in it: 10 us of busy device in a 19 us span
    events = [("init", 0.0, 1.0), ("nested", 2.5, 1.0)]
    for k in range(3):
        events += [("a", 2.0 + 6 * k, 2.0), ("b", 4.0 + 6 * k, 1.0)]
    events.append(("b", 19.0, 0.0))
    out = loop_kernel_summary(events, trips=3)
    assert out["kernel_names_in_loop"] == 2
    assert out["kernels_per_iteration"] == 7 / 3
    assert out["device_us_per_iteration"] == 3.0
    assert out["kernels_outside_loop"] == 2
    assert abs(out["kernel_span_s"] - 19e-6) < 1e-12
    assert abs(out["device_busy_share"] - 10.0 / 19.0) < 1e-12
