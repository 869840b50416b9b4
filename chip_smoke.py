#!/usr/bin/env python
"""On-card smoke test: drive the planner's main path once on one GPU.

    python chip_smoke.py                # phases (a)-(f) on one card
    python chip_smoke.py --four-cards   # only the four-card shard_map path

Everything runs in one process, in order, and any failed phase ends the
script with a nonzero exit code:

  (a) device      JAX's first device is a GPU; its kind, the device count,
                  XLA_FLAGS and nvidia-smi's name and power limit.
  (b) offline     examples/offline_trajectory.py at --seed 3, the written
                  file re-integrated independently of the solver.
  (c) parity      one chained-workload QP batch (B=256) solved by the
                  structured backend and by the dense reference on the GPU;
                  a B=64 chained solve on the GPU and on the host CPU.
  (d) acceptance  the reference's 1000-trajectory protocol (batch 250),
                  gated like the committed acceptance artifact.
  (e) headline    bench.py's chained workload at B=2048.
  (f) stages      per-stage times of the solve at B=2048, and a profiler
                  trace of one QP: device kernels and time per ADMM
                  iteration, the device's busy share.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits nonzero and prints no result.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
OUT_DIR = os.path.join(REPO, "chiprun_out")

# tests/test_qp_structured.py::test_structured_backend_matches_xla_on_planner_qps:
# identical converged flags, iterates within rtol/atol, iteration counts
# within one residual-check window. Held in float64.
QP_PARITY_TOL = {"rtol": 1e-5, "atol": 1e-6, "iterations_atol": 26}
# The same QPs in float32: the structured backend at its shipping settings
# against the dense reference with one KKT refinement step (without it the
# dense explicit inverse stalls: 0 of 256 of these QPs converge, on the
# host CPU as on the card). These QPs are nearly degenerate, so the two
# arms stop at different points inside the ADMM tolerance (on the host
# CPU, x differs by up to 0.23 where both converged) and iterates are not
# compared. What is held: the reference converges; the structured backend
# converges only where the reference does, and on nearly as many QPs;
# where both converged, the objectives agree and the structured steps'
# largest hard-row violation is the reference's within hard_viol_slack
# (one problem's may differ by more: each arm stops inside its own
# tolerance). On the host CPU at B=256: reference 256/256, structured
# 245/256 (all inside the reference's), objective relative difference
# <= 0.024, largest hard-row violation 0.012857 vs 0.012866 (per problem
# up to 0.0021 apart).
QP_PARITY_F32_TOL = {"ref_conv_min": 0.99, "flag_mismatch_max": 0.05,
                     "objective_rel": 0.05, "hard_viol_slack": 1e-3}
# GPU vs host CPU on the same chained batch, both float32 at "highest":
# the same program compiled twice sums in different orders, so iterates
# differ in the last bits; the outcome a user sees must not: t_f, and
# tol_hit trajectory by trajectory. QP convergence is held one-sided: the
# GPU may converge no less than the CPU minus qp_conv_abs. The host CPU's
# float32 ADMM stalls at the 700 cap on a few near-tolerance QPs that
# converge in float64 (this batch, seed 1 and B=64, on the host CPU:
# float64 converges all 128 QPs in <= 225 iterations, float32 leaves 2-4
# at the cap), so a GPU that converges more is closer to the float64
# answer, not wrong.
DEVICE_PARITY_TOL = {"tf_rel": 1e-3, "tf_share": 0.95, "tol_hit_mismatches": 0,
                     "qp_conv_abs": 0.01}
# .claude/skills/verify/SKILL.md: re-integrated velocity vs the written
# velocity, and the final position inside the 1e-2 terminal box plus the
# QP's eps_abs.
OFFLINE_TOL = {"v_consistency": 5e-3, "q_err": 1e-2 + 1e-3}
# Reference-convention failure totals of the committed float32 acceptance
# artifact (analysis/benchmark_data_r05.txt.gz): MPC and warm start.
ARTIFACT_TOTALS = {"mpc": 267, "warm_start": 290}
MARGINS = (0.8, 0.8, 0.6, 0.9, 0.1)


def log(phase, **values):
    print(json.dumps({"phase": phase, **values}), flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def submit(pool, fn):
    """pool.submit(fn) under the calling thread's float64 setting: JAX
    keeps `jax.enable_x64` contexts per thread, so a pool thread would
    otherwise trace with the process default."""
    import jax

    x64 = jax.config.jax_enable_x64

    def run():
        with jax.enable_x64(x64):
            return fn()

    return pool.submit(run)


def timed(fn, *args):
    """fn(*args) to completion, and its wall seconds."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------


def check_device(count=1):
    """The first `count` devices, after checking JAX reports GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX reports platform {devices[0].platform!r}"
        )
    require(len(devices) >= count, f"{count} GPUs (found {len(devices)})")
    return devices[:count]


def nvidia_smi():
    """nvidia-smi's name and power limit of each card, from a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    require(out, "nvidia-smi printed the card's name and power limit")
    return out.splitlines()


def device_phase(count=1):
    import jax

    devices = check_device(count)
    log("device", device_kind=devices[0].device_kind,
        device_count=len(jax.devices()),
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=jax.config.jax_compilation_cache_dir)
    for line in nvidia_smi():
        print(line, flush=True)


def last_line():
    import jax

    dev = jax.devices()[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }})


# ---------------------------------------------------------------------------
# (b) offline trajectory
# ---------------------------------------------------------------------------


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reintegrate(path):
    """Independent check of a 29-column trajectory file (1 target line +
    201 warm-start rows + 201 MPC rows): trapezoidal re-integration of the
    MPC accelerations against its velocities, and the final position
    against the target. Returns (v_consistency, q_err)."""
    import numpy as np

    d = np.loadtxt(path)
    tgt, mpc = d[0], d[202:403]
    t, q, v, a = mpc[:, 0], mpc[:, 1:8], mpc[:, 8:15], mpc[:, 15:22]
    dt = np.diff(t)[:, None]
    v_int = v[0] + np.cumsum(0.5 * (a[1:] + a[:-1]) * dt, axis=0)
    return float(np.abs(v_int - v[1:]).max()), float(np.abs(q[-1] - tgt[1:8]).max())


def offline_phase(seed=3):
    path = os.path.join(OUT_DIR, "optimal_solution.txt")
    _example("offline_trajectory").main(["--seed", str(seed), "--out", path])
    v_cons, q_err = reintegrate(path)
    log("offline", seed=seed, v_consistency=v_cons, final_q_err=q_err,
        tolerances=OFFLINE_TOL)
    require(v_cons < OFFLINE_TOL["v_consistency"], "offline v-consistency")
    require(q_err <= OFFLINE_TOL["q_err"], "offline final q error")


# ---------------------------------------------------------------------------
# (c) parity at real widths
# ---------------------------------------------------------------------------


def shipping_planner(**qp_overrides):
    import jax

    from mpc_motion_planner_tpu.config import shipping_qp_settings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    return MotionPlanner(
        margins=Margins(*MARGINS),
        qp_settings=shipping_qp_settings(jax.default_backend(), **qp_overrides),
    )


def chained_qp(planner, batch, seed=0):
    """The first SQP step's QP on the chained workload, posed as
    ops/sqp.py poses it (soft nonlinear rows and elastic variable box),
    in structured and in dense form."""
    import jax

    from mpc_motion_planner_tpu.bench.harness import chain_states

    cur, tgt = chain_states(planner, jax.random.PRNGKey(seed), batch)
    return jax.jit(lambda c, t: _pose_qp(planner, c, t))(cur, tgt)


def _pose_qp(planner, cur, tgt):
    import jax
    import jax.numpy as jnp

    from mpc_motion_planner_tpu.ops import sqp, structure

    ocp = planner.ocp
    batch = cur.shape[0]
    bounds = planner.nlp_bounds(cur, tgt)
    z = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    with jax.default_matmul_precision("highest"):
        c_eq = jax.vmap(ocp.eq_residual)(z)
        g, J = ocp.linearize_constraints_batch(z)
        sa = structure.build_structured_A(ocp, z, J=J)
        A = structure.materialize(ocp, sa)
    h = jax.vmap(ocp.cost_gradient)(z)
    s = planner.sqp_settings
    lb_g = jnp.broadcast_to(bounds.lb_ineq, g.shape)
    ub_g = jnp.broadcast_to(bounds.ub_ineq, g.shape)
    m = ocp.num_eq + ocp.num_ineq
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    wx = jnp.zeros((ocp.num_var,), z.dtype)
    wx = wx.at[nx : (nodes - 1) * nx].set(s.box_slack_penalty)
    wx = wx.at[nodes * nx : nodes * (nx + nu)].set(s.box_slack_penalty)
    return dict(
        sa=sa, A=A,
        P=sqp.hessian_regularization_diag(ocp, (batch,), z.dtype, s.reg_eps),
        q=h,
        lc=jnp.concatenate([-c_eq, lb_g - g], axis=-1),
        uc=jnp.concatenate([-c_eq, ub_g - g], axis=-1),
        lx=jnp.broadcast_to(bounds.lb_var, z.shape) - z,
        ux=jnp.broadcast_to(bounds.ub_var, z.shape) - z,
        soft_c=jnp.zeros((batch, m), z.dtype).at[:, ocp.num_eq :].set(s.slack_penalty),
        soft_x=jnp.broadcast_to(wx, z.shape),
    )


def solve_qp_pair(ocp, data, settings, ref_settings=None):
    """The same QPs by the structured backend (`settings`) and the dense
    reference (`ref_settings`, by default `settings`)."""
    import dataclasses

    import jax

    from mpc_motion_planner_tpu.ops.qp import solve_box_qp
    from mpc_motion_planner_tpu.ops.qp_structured import solve_box_qp_structured

    d = data
    soft = dict(soft_c=d["soft_c"], soft_x=d["soft_x"])
    structured = jax.jit(lambda d: solve_box_qp_structured(
        ocp, d["sa"], d["P"], d["q"], d["lc"], d["uc"], d["lx"], d["ux"],
        dataclasses.replace(settings, backend="structured"), **soft,
    ))
    dense = jax.jit(lambda d: solve_box_qp(
        d["P"], d["q"], d["A"], d["lc"], d["uc"], d["lx"], d["ux"],
        dataclasses.replace(ref_settings or settings, backend="xla"), **soft,
    ))
    got, t_got = timed(structured, d)
    ref, t_ref = timed(dense, d)
    log("qp_pair_first_call_s", structured=t_got, dense=t_ref)
    return got, ref


def compare_qp(got, ref):
    """Agreement figures of two QPSolutions, and whether they meet
    QP_PARITY_TOL."""
    import numpy as np

    x, xr = np.asarray(got.x), np.asarray(ref.x)
    it, itr = np.asarray(got.iterations), np.asarray(ref.iterations)
    flags_equal = bool(np.array_equal(np.asarray(got.converged), np.asarray(ref.converged)))
    close = np.isclose(x, xr, rtol=QP_PARITY_TOL["rtol"], atol=QP_PARITY_TOL["atol"])
    figures = {
        "conv_structured": float(np.asarray(got.converged).mean()),
        "conv_dense": float(np.asarray(ref.converged).mean()),
        "converged_flags_equal": flags_equal,
        "x_max_abs_diff": float(np.abs(x - xr).max()),
        "x_share_within_tol": float(close.mean()),
        "iterations_max_abs_diff": int(np.abs(it - itr).max()),
        "finite": bool(np.isfinite(x).all() and np.isfinite(xr).all()),
    }
    ok = (
        flags_equal and bool(close.all())
        and figures["iterations_max_abs_diff"] <= QP_PARITY_TOL["iterations_atol"]
    )
    return figures, ok


def qp_objective(sol, data):
    """Per QP, in float64: the objective 0.5 x'Px + q'x plus the soft
    rows' weighted l1 violations, and the largest violation of a hard row
    (general rows and variable box)."""
    import numpy as np

    d = {k: np.asarray(v, np.float64) for k, v in data.items() if k != "sa"}
    x = np.asarray(sol.x, np.float64)
    Ax = np.einsum("bmn,bn->bm", d["A"], x)
    viol_c = np.maximum(Ax - d["uc"], 0.0) + np.maximum(d["lc"] - Ax, 0.0)
    viol_x = np.maximum(x - d["ux"], 0.0) + np.maximum(d["lx"] - x, 0.0)
    soft_c = np.broadcast_to(d["soft_c"], viol_c.shape)
    soft_x = np.broadcast_to(d["soft_x"], viol_x.shape)
    f = (0.5 * d["P"] * x * x + d["q"] * x).sum(-1)
    f += (soft_c * viol_c).sum(-1) + (soft_x * viol_x).sum(-1)
    hard = np.maximum(np.where(soft_c == 0, viol_c, 0.0).max(-1),
                      np.where(soft_x == 0, viol_x, 0.0).max(-1))
    return f, hard


def compare_qp_f32(got, ref, data):
    """Agreement figures of the float32 pair (`ref` the dense reference),
    and whether they meet QP_PARITY_F32_TOL."""
    import numpy as np

    tol = QP_PARITY_F32_TOL
    conv, conv_ref = np.asarray(got.converged), np.asarray(ref.converged)
    both = conv & conv_ref
    f, hard = qp_objective(got, data)
    f_ref, hard_ref = qp_objective(ref, data)
    rel = np.abs(f - f_ref) / np.maximum(np.abs(f_ref), 1.0)
    excess = hard - hard_ref
    finite = bool(np.isfinite(np.asarray(got.x)).all()
                  and np.isfinite(np.asarray(ref.x)).all())
    figures = {
        "conv_structured": float(conv.mean()),
        "conv_dense_refined": float(conv_ref.mean()),
        "converged_only_structured": int((conv & ~conv_ref).sum()),
        "flag_mismatch_share": float((conv != conv_ref).mean()),
        "both_converged": int(both.sum()),
        "objective_rel_diff_max": float(rel[both].max()) if both.any() else None,
        "hard_viol_max": [float(hard[both].max()), float(hard_ref[both].max())]
        if both.any() else None,
        "hard_viol_per_qp_excess_max": float(excess[both].max()) if both.any() else None,
        "finite": finite,
    }
    ok = bool(
        finite and both.any()
        and figures["conv_dense_refined"] >= tol["ref_conv_min"]
        and figures["converged_only_structured"] == 0
        and figures["flag_mismatch_share"] <= tol["flag_mismatch_max"]
        and figures["objective_rel_diff_max"] <= tol["objective_rel"]
        and figures["hard_viol_max"][0]
        <= figures["hard_viol_max"][1] + tol["hard_viol_slack"]
    )
    return figures, ok


def qp_parity(batch=256, **qp_overrides):
    """Structured vs dense on one chained QP batch, in float64 (the CPU
    parity test's settings) and rounded to float32 (the structured backend
    at the shipping settings, the reference with one KKT refinement step).
    Returns the float64 and float32 figures, each with its verdict."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mpc_motion_planner_tpu.ops.qp import QPSettings

    with jax.enable_x64(True):
        planner = shipping_planner()
        data = chained_qp(planner, batch)
        settings = QPSettings(**{"max_iter": 700, "kkt_refine": 0, **qp_overrides})
        f64, ok64 = compare_qp(*solve_qp_pair(planner.ocp, data, settings))
        # the same QPs rounded to float32
        data = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a, data
        )
    planner = shipping_planner()
    ship = shipping_qp(planner, **qp_overrides)
    got, ref = solve_qp_pair(
        planner.ocp, data, ship, dataclasses.replace(ship, kkt_refine=1)
    )
    f32, ok32 = compare_qp_f32(got, ref, data)
    return f64, ok64, f32, ok32


def qp_parity_phase(batch=256):
    f64, ok64, f32, ok32 = qp_parity(batch)
    log("qp_parity", batch=batch, float64_tolerances=QP_PARITY_TOL, float64=f64,
        float32_tolerances=QP_PARITY_F32_TOL, float32=f32)
    require(ok64, "float64 structured vs dense QP parity")
    require(ok32, "float32 structured vs refined dense QP parity")


def shipping_qp(planner, **overrides):
    import dataclasses

    return dataclasses.replace(planner.qp_settings, **overrides)


def outcome(planner, sol, target):
    """Per-trajectory t_f, terminal-box hit of the re-simulated final
    state (headline convention) and QP convergence (B, sqp_iters)."""
    import jax.numpy as jnp

    xT = sol.x_at(jnp.ones((), sol.z.dtype))
    err = jnp.max(jnp.abs(xT - target), axis=-1)
    tol = planner.target_eps + planner.qp_settings.eps_abs
    return sol.final_time, err <= tol, sol.qp_converged


def compare_outcomes(a, b):
    """Agreement of two `outcome` triples against DEVICE_PARITY_TOL; `b`
    is the reference."""
    import numpy as np

    tf_a, hit_a, conv_a = (np.asarray(v) for v in a)
    tf_b, hit_b, conv_b = (np.asarray(v) for v in b)
    rel = np.abs(tf_a - tf_b) / np.maximum(np.abs(tf_b), 1e-12)
    figures = {
        "tf_share_within": float((rel <= DEVICE_PARITY_TOL["tf_rel"]).mean()),
        "tf_rel_diff_max": float(rel.max()),
        "tol_hit": [float(hit_a.mean()), float(hit_b.mean())],
        "tol_hit_mismatches": int((hit_a != hit_b).sum()),
        "qp_conv": [float(conv_a.mean()), float(conv_b.mean())],
    }
    ok = (
        figures["tf_share_within"] >= DEVICE_PARITY_TOL["tf_share"]
        and figures["tol_hit_mismatches"] <= DEVICE_PARITY_TOL["tol_hit_mismatches"]
        and figures["qp_conv"][0]
        >= figures["qp_conv"][1] - DEVICE_PARITY_TOL["qp_conv_abs"]
    )
    return figures, ok


def device_parity_phase(batch=64, **qp_overrides):
    """The same chained batch solved on the GPU and on the host CPU."""
    import jax

    from mpc_motion_planner_tpu.bench.harness import chain_states

    planner = shipping_planner(**qp_overrides)
    cur, tgt = chain_states(planner, jax.random.PRNGKey(1), batch)
    solve = jax.jit(planner.solve)
    judge = jax.jit(lambda sol, t: outcome(planner, sol, t))
    cpu = jax.devices("cpu")[0]
    cur_c, tgt_c = jax.device_put((cur, tgt), cpu)
    # the host compile overlaps the GPU compile and solve
    with ThreadPoolExecutor(1) as pool:
        for_cpu = submit(pool, lambda: solve.lower(cur_c, tgt_c).compile())
        sol, t_gpu = timed(solve, cur, tgt)
        on_gpu = judge(sol, tgt)
        t0 = time.perf_counter()
        solve_cpu = for_cpu.result()
        t_wait = time.perf_counter() - t0
    with jax.default_device(cpu):
        sol, t_cpu = timed(solve_cpu, cur_c, tgt_c)
        on_cpu = judge(sol, tgt_c)
    figures, ok = compare_outcomes(on_gpu, on_cpu)
    log("device_parity", batch=batch, tolerances=DEVICE_PARITY_TOL,
        gpu_vs_cpu=figures,
        seconds={"gpu_first_call": t_gpu, "cpu_compile_wait": t_wait,
                 "cpu_solve": t_cpu})
    require(ok, "GPU vs CPU chained solve")
    return figures


# ---------------------------------------------------------------------------
# (d) acceptance, (e) headline, (f) stages
# ---------------------------------------------------------------------------


def acceptance_gates(summary):
    """The gates of the committed acceptance artifact
    (tests/test_benchmark.py::test_committed_acceptance_artifact_matches_results_md)
    plus QP convergence. Returns {gate: passed}."""
    mpc = summary["reference"]["mpc"]
    return {
        "mpc position/velocity/torqueAccel/jerk fails == 0": all(
            mpc[k] == 0 for k in
            ("position_fails", "velocity_fails", "torqueAccel_fails", "Jerk_fails")
        ),
        "mpc within_box_plus_tol == 1.0":
            summary["accuracy"]["mpc"]["within_box_plus_tol"] == 1.0,
        "mpc total <= warm start total":
            mpc["total"] <= summary["reference"]["ruckig"]["total"],
        "qp_conv_rate >= 0.99": summary["qp_conv_rate"] >= 0.99,
    }


def acceptance_phase(n=1000, batch=250):
    from mpc_motion_planner_tpu.bench import acceptance

    path = os.path.join(OUT_DIR, "benchmark_data.txt")
    if os.path.exists(path):
        os.remove(path)  # the records file is opened in append mode
    summary = acceptance.main(["--n", str(n), "--batch", str(batch), "--out", path])
    gates = acceptance_gates(summary)
    log("acceptance", n=n, batch=batch,
        reference_totals={"mpc": summary["reference"]["mpc"]["total"],
                          "warm_start": summary["reference"]["ruckig"]["total"]},
        artifact_totals=ARTIFACT_TOTALS, qp_conv_rate=summary["qp_conv_rate"],
        solves_per_s=summary["solves_per_s"], gates=gates)
    require(all(gates.values()), f"acceptance gates {gates}")


def headline_phase(batch=2048):
    from mpc_motion_planner_tpu.bench import headline

    r = headline.main(batch=batch)
    require(r["platform"] == "gpu" and r["qp_backend"] == "structured",
            "headline ran the structured backend on the GPU")
    require(r["finite"], "headline solutions finite")
    require(r["tol_hit_rate"] >= 0.99, "headline tol_hit_rate >= 0.99")
    require(r["qp_conv_rate"] >= 0.99, "headline qp_conv_rate >= 0.99")


def stages_phase(batch=2048):
    import jax

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.utils.profiling import stage_timings_structured

    planner = shipping_planner()
    cur, tgt = chain_states(planner, jax.random.PRNGKey(0), batch)
    trace_dir = os.path.join(OUT_DIR, "qp_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out = stage_timings_structured(planner, cur, tgt, trace_dir=trace_dir)
    log("stages", batch=batch, median_s={
        k: v["median_s"] for k, v in out.items()
        if isinstance(v, dict) and "median_s" in v
    }, admm_loop_derived_s=out["admm_loop_derived_s"],
        solves_per_s=out["solves_per_s"], qp_trace=out["qp_trace"])
    require(out["qp_trace"]["kernels"] > 0, "the traced QP ran kernels on the device")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def four_cards_phase(batch=2048, cards=4):
    """shard_map_solve_fn over a 1-D mesh of `cards` GPUs against a
    one-card solve of the same chained batch."""
    import jax

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_map_solve_fn,
    )

    devices = check_device(cards)
    planner = shipping_planner()
    cur, tgt = chain_states(planner, jax.random.PRNGKey(0), batch)
    mesh = make_mesh(devices)
    step = shard_map_solve_fn(planner, mesh)
    # the one-card arm is bench.py's program (jit of planner.solve)
    one_card = jax.jit(planner.solve)
    judge = jax.jit(lambda sol, t: outcome(planner, sol, t))
    cur_s, tgt_s = shard_batch(mesh, (cur, tgt))
    cur_1, tgt_1 = jax.device_put((cur, tgt), devices[0])

    # the two programs compile side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        step_c = submit(pool, lambda: step.lower(cur_s, tgt_s).compile())
        one_card_c = submit(pool, lambda: one_card.lower(cur_1, tgt_1).compile())
        step, one_card = step_c.result(), one_card_c.result()
    compile_s = time.perf_counter() - t0
    _, c_sharded = timed(step, cur_s, tgt_s)
    (sol_s, _), t_sharded = timed(step, cur_s, tgt_s)
    _, c_single = timed(one_card, cur_1, tgt_1)
    sol_1, t_single = timed(one_card, cur_1, tgt_1)
    require(len(sol_s.z.addressable_shards) == cards, "output sharded over the mesh")
    sharded, single = judge(sol_s, tgt_s), judge(sol_1, tgt_1)
    figures, ok = compare_outcomes(sharded, single)
    log("four_cards", batch=batch, per_card=batch // cards,
        tolerances=DEVICE_PARITY_TOL, sharded_vs_one_card=figures,
        compile_both_s=compile_s,
        first_call_s={"sharded": c_sharded, "one_card": c_single},
        wall_s={"sharded": t_sharded, "one_card": t_single},
        solves_per_s={"sharded": batch / t_sharded, "one_card": batch / t_single})
    require(ok, "sharded vs one-card solve")


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only shard_map_solve_fn on four cards against "
                         "a one-card solve of the same batch")
    args = ap.parse_args(argv)

    from mpc_motion_planner_tpu.config import setup

    check_device(4 if args.four_cards else 1)
    setup()
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.four_cards:
        phases = [("device", lambda: device_phase(4)), ("four_cards", four_cards_phase)]
    else:
        phases = [
            ("device", device_phase),
            ("offline", offline_phase),
            ("qp_parity", qp_parity_phase),
            ("device_parity", device_parity_phase),
            ("acceptance", acceptance_phase),
            ("headline", headline_phase),
            ("stages", stages_phase),
        ]
    t_start = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log("phase_done", name=name, seconds=time.perf_counter() - t0)
    log("all_done", seconds=time.perf_counter() - t_start)
    print(last_line(), flush=True)


if __name__ == "__main__":
    main()
