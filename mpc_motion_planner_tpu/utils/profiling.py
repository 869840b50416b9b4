"""Profiling / tracing utilities.

The reference's only instrumentation is a chrono timer around mpc.solve()
whose result is discarded (/root/reference/mpc_solver/motionPlanner.cpp:
182-196). Here profiling is a first-class subsystem (SURVEY.md §5):

* :func:`trace` — context manager around ``jax.profiler.trace`` for
  XLA device timeline captures viewable in TensorBoard/Perfetto.
* :func:`trace_events` / :func:`loop_kernel_summary` — read the device
  kernels of such a capture and attribute them to a loop: kernels per
  iteration, device time per iteration, the device's busy share.
* :func:`time_fn` — wall-clock a jitted callable with compile/transfer
  excluded (warmup + block_until_ready), returning solves/s.
* :func:`stage_timings` — decompose a planner solve into its pipeline
  stages (warm start -> linearize -> QP -> line search) by timing each
  stage's jitted closure on the same inputs. Stages are timed separately
  (XLA fuses them in the real solve, so the sum slightly over-counts
  shared work — the numbers are for attribution, not accounting).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax profiler trace into ``log_dir``, with a Perfetto JSON
    copy for :func:`trace_events`."""
    jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_line(process: str, thread: str) -> bool:
    """Trace lines that carry device kernels: the GPU's streams, or the
    threads that run XLA's host CPU programs."""
    if process.startswith("/device:"):
        return thread.startswith("Stream")
    return "XLAPjRtCpuClient" in thread


def trace_events(log_dir: str) -> List[Tuple[str, float, float]]:
    """(name, start_us, duration_us) of every complete event on the
    :func:`device_line` lines of the newest Perfetto JSON under
    ``log_dir`` (written by :func:`trace`). The host CPU runtime's
    "end: <op>" markers are dropped."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(max(paths, key=os.path.getmtime)) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    process, thread = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            process[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            thread[(e["pid"], e["tid"])] = e["args"]["name"]
    return [
        (e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
        for e in events
        if e.get("ph") == "X"
        and not e["name"].startswith("end: ")
        and device_line(process.get(e["pid"], ""), thread.get((e["pid"], e.get("tid")), ""))
    ]


def loop_kernel_summary(events, trips: int) -> Dict:
    """Attribute device kernels (:func:`trace_events`) to a loop that ran
    ``trips`` times: a kernel name that ran at least ``trips`` times is
    the loop's. Also the device's busy share: the time at least one
    kernel ran (overlapping and nested events counted once) over the span
    from the first kernel's start to the last one's end."""
    counts = collections.Counter(n for n, _, _ in events)
    time_us = collections.defaultdict(float)
    for n, _, dur in events:
        time_us[n] += dur
    loop = [n for n, c in counts.items() if c >= trips]
    loop_count = sum(counts[n] for n in loop)
    loop_us = sum(time_us[n] for n in loop)
    total_us = sum(time_us.values())
    start = min(t for _, t, _ in events)
    span_us = max(t + d for _, t, d in events) - start
    busy_us, reach = 0.0, start
    for t, d in sorted((t, d) for _, t, d in events):
        busy_us += max(t + d - max(t, reach), 0.0)
        reach = max(reach, t + d)
    return {
        "trips": trips,
        "kernels": len(events),
        "kernel_names_in_loop": len(loop),
        "kernels_per_iteration": loop_count / trips,
        "device_us_per_iteration": loop_us / trips,
        "kernels_outside_loop": len(events) - loop_count,
        "kernel_time_s": total_us * 1e-6,
        "kernel_span_s": span_us * 1e-6,
        "device_busy_share": busy_us / span_us if span_us > 0 else 0.0,
        # the eight kernels that took the most time: [name, count, seconds]
        "top": [
            [n, counts[n], time_us[n] * 1e-6]
            for n in sorted(time_us, key=time_us.get, reverse=True)[:8]
        ],
    }


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1) -> Dict[str, float]:
    """Median wall time of ``jax.block_until_ready(fn(*args))`` in seconds."""
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    del out
    times.sort()
    return {
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
    }


def stage_timings_structured(
    planner, current_state, target_state, repeats: int = 3, trace_dir: str | None = None
):
    """Per-stage wall times of one batched solve on the shipping path
    (the structured QP backend, diagonal P).

    Unlike :func:`stage_timings` (which exercises the dense reference
    path), this decomposes the solve exactly as the structured SQP runs
    it: warm start -> linearize (residuals + matrix-free structured A +
    cost gradient) -> Ruiz -> banded-KKT assembly -> factorization -> the
    full QP stage -> line search -> total. Stages are timed as separate
    jitted closures on identical inputs; XLA fuses them inside the real
    solve, so the sum over-counts slightly — attribution, not accounting.

    With ``trace_dir``, one more call of the QP stage is traced there and
    ``out["qp_trace"]`` holds its :func:`loop_kernel_summary` over the
    ADMM loop (as many trips as the batch's most iterations).
    """
    from ..config import qp_backend

    if planner.qp_settings.backend != qp_backend(jax.default_backend()):
        raise ValueError(
            f"stage_timings_structured times the shipping backend "
            f"{qp_backend(jax.default_backend())!r}, got "
            f"{planner.qp_settings.backend!r}"
        )

    from ..ops import sqp as sqp_mod
    from ..ops.qp import QPSettings, _rho_pattern
    from ..ops.qp_structured import (
        assemble_banded_M,
        factor_arrow,
        ruiz_structured,
        solve_box_qp_structured,
    )
    from ..ops.structure import build_structured_A

    ocp = planner.ocp
    B = current_state.shape[0]
    settings: QPSettings = planner.qp_settings
    K, nx = ocp.coll.order + 1, ocp.nx
    # Every stage takes its arrays as arguments: closing over batch-sized
    # arrays would bake them into the programs as constants.

    @jax.jit
    def warm(cur, tgt):
        traj = planner.plan_warm_start(cur, tgt)
        return planner.warm_start_vector(traj)

    @jax.jit
    def linearize(z):
        # exactly the SQP linearization (ocp.linearize_constraints_batch)
        with jax.default_matmul_precision("highest"):
            c_eq = jax.vmap(ocp.eq_residual)(z)
            g, J = ocp.linearize_constraints_batch(z)
            return (
                c_eq,
                g,
                build_structured_A(ocp, z, J=J),
                jax.vmap(ocp.cost_gradient)(z),
            )

    @jax.jit
    def ruiz(sa):
        with jax.default_matmul_precision("highest"):
            return ruiz_structured(ocp, sa, settings.ruiz_iters)

    @jax.jit
    def assemble(sa, D, E, rc, sig):
        with jax.default_matmul_precision("highest"):
            w = E * E * rc
            w_eq = w[:, : ocp.num_eq].reshape(B, -1, K, nx)
            w_g = w[:, ocp.num_eq :].reshape(B, ocp.num_nodes, -1)
            return assemble_banded_M(ocp, sa, w_eq, w_g, D, sig)

    @jax.jit
    def factor(Mband, p_col, m_pp):
        with jax.default_matmul_precision("highest"):
            return factor_arrow(Mband, p_col, m_pp, ocp.coll.order)

    # soft elastic rows exactly as the SQP builds them (SQPSettings)
    m = ocp.num_eq + ocp.num_ineq
    sqp_set = planner.sqp_settings
    dt = current_state.dtype
    soft_c = None
    if sqp_set.slack_penalty > 0:
        soft_c = jnp.zeros((1, m), dt).at[:, ocp.num_eq :].set(
            sqp_set.slack_penalty
        )
    soft_x = None
    if sqp_set.box_slack_penalty > 0:
        nodes, nx_, nu_ = ocp.num_nodes, ocp.nx, ocp.nu
        wx = jnp.zeros((ocp.num_var,), dt)
        wx = wx.at[nx_ : (nodes - 1) * nx_].set(sqp_set.box_slack_penalty)
        wx = wx.at[nodes * nx_ : nodes * (nx_ + nu_)].set(
            sqp_set.box_slack_penalty
        )
        soft_x = wx[None, :]

    @jax.jit
    def qp_stage(sa, P_diag, h, lc, uc, lx, ux):
        return solve_box_qp_structured(
            ocp, sa, P_diag, h, lc, uc, lx, ux, settings,
            soft_c=soft_c, soft_x=soft_x,
        )

    @jax.jit
    def line_search(z, d, h, bounds):
        with jax.default_matmul_precision("highest"):
            mu = jnp.full(z.shape[:1], 10.0, z.dtype)
            return sqp_mod._line_search(
                ocp, bounds, z, d, h, mu, planner.sqp_settings
            )

    # ---- the stage inputs, as the first SQP step sees them ----
    z0 = warm(current_state, target_state)
    bounds = planner.nlp_bounds(current_state, target_state)
    c_eq, g, sa, h = linearize(z0)
    P_diag = sqp_mod.hessian_regularization_diag(
        ocp, (B,), dt, planner.sqp_settings.reg_eps
    )
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))
    lc = jnp.concatenate([-c_eq, lb_g - g], axis=-1)
    uc = jnp.concatenate([-c_eq, ub_g - g], axis=-1)
    lx = jnp.broadcast_to(bounds.lb_var, z0.shape) - z0
    ux = jnp.broadcast_to(bounds.ub_var, z0.shape) - z0
    D, E = ruiz(sa)
    rx = settings.rho * _rho_pattern(lx, ux, settings)
    rc = settings.rho * _rho_pattern(lc, uc, settings)
    sig = D * P_diag * D + settings.sigma + rx
    Mband, p_col, m_pp = assemble(sa, D, E, rc, sig)
    qp_args = (sa, P_diag, h, lc, uc, lx, ux)
    qp_sol = qp_stage(*qp_args)
    d = qp_sol.x

    total_fn = jax.jit(planner.solve)

    out = {
        "warm_start": time_fn(warm, current_state, target_state, repeats=repeats),
        "linearize": time_fn(linearize, z0, repeats=repeats),
        "ruiz": time_fn(ruiz, sa, repeats=repeats),
        "assemble_banded": time_fn(assemble, sa, D, E, rc, sig, repeats=repeats),
        "factor": time_fn(factor, Mband, p_col, m_pp, repeats=repeats),
        "qp": time_fn(qp_stage, *qp_args, repeats=repeats),
        "line_search": time_fn(line_search, z0, d, h, bounds, repeats=repeats),
        "total": time_fn(total_fn, current_state, target_state, repeats=repeats),
    }
    out["batch"] = B
    out["solves_per_s"] = B / out["total"]["median_s"]
    # the ADMM iteration loop = QP stage minus its setup (attribution)
    out["admm_loop_derived_s"] = max(
        out["qp"]["median_s"]
        - out["ruiz"]["median_s"]
        - out["assemble_banded"]["median_s"]
        - out["factor"]["median_s"],
        0.0,
    )
    if trace_dir is not None:
        with trace(trace_dir):
            t0 = time.perf_counter()
            jax.block_until_ready(qp_stage(*qp_args))
            wall_s = time.perf_counter() - t0
        trips = int(jnp.max(qp_sol.iterations))
        out["qp_trace"] = {
            **loop_kernel_summary(trace_events(trace_dir), trips),
            "traced_wall_s": wall_s,
        }
    return out


def stage_timings(planner, current_state, target_state, repeats: int = 3):
    """Per-stage wall times of one batched solve.

    Returns a dict of stage -> timing dict (see :func:`time_fn`) with keys
    ``warm_start``, ``linearize``, ``qp``, ``line_search``, ``total`` plus
    ``batch`` and ``solves_per_s`` derived from ``total``.
    """
    from ..ops import sqp as sqp_mod
    from ..ops.qp import solve_box_qp

    ocp = planner.ocp
    B = current_state.shape[0]

    @jax.jit
    def warm(cur, tgt):
        traj = planner.plan_warm_start(cur, tgt)
        return planner.warm_start_vector(traj)

    z0 = warm(current_state, target_state)
    bounds = planner.nlp_bounds(current_state, target_state)

    @jax.jit
    def linearize(z):
        with jax.default_matmul_precision("highest"):
            return (
                jax.vmap(ocp.eq_residual)(z),
                jax.vmap(ocp.ineq_residual)(z),
                jax.vmap(ocp.constraint_matrix)(z),
                jax.vmap(ocp.cost_gradient)(z),
            )

    c_eq, g, A, h = linearize(z0)
    dt = z0.dtype
    P_diag = sqp_mod.hessian_regularization_diag(
        ocp, (B,), dt, planner.sqp_settings.reg_eps
    )
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))
    lc = jnp.concatenate([-c_eq, lb_g - g], axis=-1)
    uc = jnp.concatenate([-c_eq, ub_g - g], axis=-1)
    lx = jnp.broadcast_to(bounds.lb_var, z0.shape) - z0
    ux = jnp.broadcast_to(bounds.ub_var, z0.shape) - z0

    @jax.jit
    def qp(P_diag, h, A, lc, uc, lx, ux):
        return solve_box_qp(P_diag, h, A, lc, uc, lx, ux, planner.qp_settings)

    sol = qp(P_diag, h, A, lc, uc, lx, ux)
    d = sol.x

    @jax.jit
    def line_search(z, d, h):
        with jax.default_matmul_precision("highest"):
            mu = jnp.full(z.shape[:1], 10.0, z.dtype)
            return sqp_mod._line_search(
                ocp, bounds, z, d, h, mu, planner.sqp_settings
            )

    total_fn = jax.jit(planner.solve)

    out = {
        "warm_start": time_fn(warm, current_state, target_state, repeats=repeats),
        "linearize": time_fn(linearize, z0, repeats=repeats),
        "qp": time_fn(qp, P_diag, h, A, lc, uc, lx, ux, repeats=repeats),
        "line_search": time_fn(line_search, z0, d, h, repeats=repeats),
        "total": time_fn(total_fn, current_state, target_state, repeats=repeats),
    }
    out["batch"] = B
    out["solves_per_s"] = B / out["total"]["median_s"]
    return out
