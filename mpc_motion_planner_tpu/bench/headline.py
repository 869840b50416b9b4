"""Headline benchmark: aggregate minimum-time MPC solve throughput per card.

Runs the 1000-trajectory Panda benchmark workload (benchmark.cpp parity:
margins 0.8/0.8/0.6/0.9/0.1, chained start states, jerk-limited warm start,
2 SQP x <=700 ADMM iterations at eps 1e-3) as batched solves on the GPU
and reports solves/s. It refuses to run without a GPU: a number from the
CPU is not a device number.

Prints ONE JSON line:
    {"metric": "solves_per_s", "value": N, "unit": "solves/s",
     "vs_baseline": N, ...}

Baseline: the C++ reference publishes no numbers and cannot be built here
(polyMPC submodule is not vendored; no pinocchio/ruckig on the image).
vs_baseline divides by 50 solves/s — the ESTIMATED single-core C++ figure,
derived step-by-step in BASELINE.md "Measured baseline proxy" and chosen
because it is conservative: the measured same-code serial proxy
(examples/baseline_proxy.py, batch-1 float64 CPU solves of this exact
workload) is 2.5 solves/s, ~20x slower. Override with
BENCH_BASELINE=<solves/s>.
"""

import json
import os
import time

# See BASELINE.md "Measured baseline proxy" for both figures' provenance.
BASELINE_SOLVES_PER_S = float(os.environ.get("BENCH_BASELINE", "0")) or 50.0


def device_info():
    """Platform, device kind, device count and XLA_FLAGS, as reported by
    JAX — printed beside every result."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def require_gpu():
    """Raise unless JAX's first device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX reports {platform!r}); the benchmark measures "
            f"the card and does not fall back to another platform"
        )


def main(batch=None, repeats=None):
    """Time the chained workload at `batch` (default BENCH_BATCH or 2048)
    on the GPU, print the result line and return it as a dict."""
    batch = batch or int(os.environ.get("BENCH_BATCH", "2048"))
    repeats = repeats or int(os.environ.get("BENCH_REPEATS", "3"))

    from mpc_motion_planner_tpu.config import setup, shipping_qp_settings

    require_gpu()
    setup()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    qp_settings = shipping_qp_settings(jax.default_backend())
    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), qp_settings=qp_settings
    )

    # The timed program is the solve alone (utils/profiling times the same
    # program as its `total` stage, so the two share one compilation).
    run = jax.jit(planner.solve)

    @jax.jit
    def terminal_errors(sol, tgt):
        # terminal error per the acceptance convention (SURVEY §4:
        # validate by re-simulation, not solver variables): the state
        # INTERPOLATED at t=1 — what a consumer sampling the trajectory
        # actually reaches — not the raw final collocation variable. Both
        # are reported; tol_hit_rate uses the re-simulated one.
        X, _, _ = sol.states()
        xT = sol.x_at(jnp.ones((), X.dtype))  # (B, nx)
        err_sim = jnp.max(jnp.abs(xT - tgt), axis=-1)
        err_node = jnp.max(jnp.abs(X[:, -1] - tgt), axis=-1)
        return err_sim, err_node

    current, target = chain_states(planner, jax.random.PRNGKey(0), batch)
    t0 = time.perf_counter()
    sol = jax.block_until_ready(run(current, target))
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(run(current, target))
        times.append(time.perf_counter() - t0)

    err_sim, err_node = terminal_errors(sol, target)
    z, violation, qp_conv = sol.z, sol.violation, sol.qp_converged
    best = min(times)
    solves_per_s = batch / best
    # Terminal-accuracy accounting: the solver's hard terminal box is
    # ±target_eps per joint (motionPlanner.hpp:44) but its rows are only
    # guaranteed to the QP's eps_abs primal tolerance, so the threshold
    # tested is target_eps + eps_abs, reported beside the measured worst
    # per-joint error.
    err_sim = np.asarray(err_sim)
    err_node = np.asarray(err_node)
    tol = planner.target_eps + qp_settings.eps_abs
    viol = np.asarray(violation)

    result = {
        "metric": "solves_per_s",
        "value": solves_per_s,
        "unit": "solves/s",
        "vs_baseline": solves_per_s / BASELINE_SOLVES_PER_S,
        "batch": batch,
        "batch_wall_s": best,
        "batch_wall_s_all": times,
        # first call: trace + compile + one run
        "first_call_s": compile_s,
        # amortized per-solve time (batch wall / batch) — NOT a latency
        # percentile; a single solve's wall time is the full batch_wall_s
        "amortized_ms_per_solve": 1e3 * best / batch,
        # fraction of solves whose RE-SIMULATED final state (trajectory
        # interpolated at t=1, the acceptance convention) is inside the
        # terminal box + QP tolerance (per-joint, threshold below)
        "tol_hit_rate": float((err_sim <= tol).mean()),
        "tol_threshold": tol,
        "terminal_err_inf_max": float(err_sim.max()),
        # the raw final collocation variable's error, for comparison with
        # the re-simulated figure (they agree to interpolation rounding)
        "node_terminal_err_max": float(err_node.max()),
        # l1 violation over all ~900 constraint rows; p90 included because
        # the median alone hides the heavy tail of the chained workload
        "median_violation": float(np.median(viol)),
        "p90_violation": float(np.percentile(viol, 90)),
        # fraction of QP subproblems converged within the iteration budget
        "qp_conv_rate": float(np.asarray(qp_conv).mean()),
        "finite": bool(np.all(np.isfinite(np.asarray(z)))),
        "qp_max_iter": qp_settings.max_iter,
        "kkt_refine": qp_settings.kkt_refine,
        "ruiz_iters": qp_settings.ruiz_iters,
        "rho": qp_settings.rho,
        "alpha": qp_settings.alpha,
        "qp_backend": qp_settings.backend,
        **device_info(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
