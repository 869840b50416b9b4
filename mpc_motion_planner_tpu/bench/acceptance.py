"""1000-trajectory acceptance benchmark — the batched equivalent of
/root/reference/examples/benchmark.cpp, with the serial loop replaced by
batched solves.

Usage (equivalently ``python examples/benchmark.py`` or the installed
``mpc-tpu-acceptance`` console script):
    mpc-tpu-acceptance [--n 1000] [--batch 250] [--platform gpu|cpu]
        [--x64] [--out analysis/benchmark_data.txt]

Writes the reference-format 162-column records and prints the per-category
violation table + accuracy stats (the analysis-notebook summaries), plus
timing. ``main`` also returns those summaries as a dict.
"""

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=250)
    ap.add_argument("--platform", default=None, choices=[None, "gpu", "cpu"])
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/benchmark_data.txt")
    ap.add_argument("--margins", type=float, nargs=5, default=[0.8, 0.8, 0.6, 0.9, 0.1],
                    help="position velocity acceleration torque jerk (benchmark.cpp:9)")
    ap.add_argument("--qp-backend", default="auto",
                    choices=["auto", "structured", "xla"],
                    help="auto resolves to the shipping backend for the "
                         "platform (config.qp_backend) — the documented "
                         "acceptance command needs no flag")
    ap.add_argument("--kkt-refine", type=int, default=None,
                    help="default: 0 for structured, 1 for xla")
    ap.add_argument("--qp-max-iter", type=int, default=700)
    ap.add_argument("--sqp-schedules", default="",
                    help="per-SQP-step ADMM caps, e.g. '700;500' "
                         "(SQPSettings.qp_step_schedules); '' keeps the "
                         "reference's shared budget")
    ap.add_argument("--rescue-iters", type=int, default=0,
                    help="extra ADMM budget for unconverged stragglers "
                         "(QPSettings.rescue_iters)")
    args = ap.parse_args(argv)

    from mpc_motion_planner_tpu.config import setup, shipping_qp_settings

    platform = setup(args.platform, args.x64)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_motion_planner_tpu.bench.analysis import (
        accuracy_stats,
        violation_counts,
        violation_counts_reference,
        violation_magnitudes,
    )
    from mpc_motion_planner_tpu.bench.harness import benchmark_records, chain_states
    from mpc_motion_planner_tpu.ops.sqp import SQPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner
    from mpc_motion_planner_tpu.utils.io import write_benchmark_records

    qp_kw = dict(max_iter=args.qp_max_iter, rescue_iters=args.rescue_iters)
    if args.qp_backend != "auto":
        qp_kw["backend"] = args.qp_backend
    if args.kkt_refine is not None:
        qp_kw["kkt_refine"] = args.kkt_refine
    elif args.qp_backend == "xla":
        qp_kw["kkt_refine"] = 1
    planner = MotionPlanner(
        margins=Margins(*args.margins),
        qp_settings=shipping_qp_settings(platform, **qp_kw),
        sqp_settings=SQPSettings(qp_step_schedules=args.sqp_schedules),
    )

    # soft-row mask for the elastic variable box (SQPSettings
    # .box_slack_penalty): interior-X nodes + all U rows — used to monitor
    # the exact-penalty assumption (box duals must stay below the weight)
    ocp = planner.ocp
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    soft_mask = np.zeros(ocp.num_var, bool)
    soft_mask[nx : (nodes - 1) * nx] = True
    soft_mask[nodes * nx : nodes * (nx + nu)] = True
    soft_mask_j = jnp.asarray(soft_mask)

    @jax.jit
    def run_batch(cur, tgt):
        sol = planner.solve(cur, tgt)
        rec, _, _ = benchmark_records(planner, sol, tgt)
        soft_dual_max = jnp.max(
            jnp.abs(sol.lam_x) * soft_mask_j, axis=-1
        )
        return rec, sol.violation, sol.qp_iterations, soft_dual_max, sol.qp_converged

    key = jax.random.PRNGKey(args.seed)
    current, target = chain_states(planner, key, args.n)

    # compile outside the timed loop (every batch has the first's shape
    # when --batch divides --n)
    t0 = time.time()
    jax.block_until_ready(run_batch(current[: args.batch], target[: args.batch]))
    print(f"compile + first batch: {time.time() - t0:.3f}s")

    all_records = []
    soft_duals, convs = [], []
    t_total = 0.0
    for i in range(0, args.n, args.batch):
        cur_b = current[i : i + args.batch]
        tgt_b = target[i : i + args.batch]
        t0 = time.time()
        rec, viol, qp_iters, sdual, conv = jax.block_until_ready(
            run_batch(cur_b, tgt_b)
        )
        dt = time.time() - t0
        t_total += dt
        all_records.append(np.asarray(rec))
        soft_duals.append(np.asarray(sdual))
        convs.append(np.asarray(conv))
        print(
            f"batch {i // args.batch}: {cur_b.shape[0]} solves in {dt:.3f}s "
            f"({cur_b.shape[0] / dt:.1f} solves/s), "
            f"median violation {np.median(np.asarray(viol)):.2e}, "
            f"qp conv {np.asarray(conv).mean():.3f}"
        )

    records = np.concatenate(all_records, axis=0)
    write_benchmark_records(args.out, records)

    print(f"\ntotal: {args.n} solves in {t_total:.2f}s = {args.n / t_total:.1f} solves/s")
    sdual = np.concatenate(soft_duals)
    conv = np.concatenate(convs)
    w = planner.sqp_settings.box_slack_penalty
    summary = {
        "qp_conv_rate": float(conv.mean()),
        # exact-penalty health check (SQPSettings.box_slack_penalty): the
        # elastic box leaves feasible solves unchanged only while the
        # optimal box duals stay below the weight — report how close the
        # measured duals get (saturation ~1.0 means the penalty binds)
        "soft_box_dual_p50": float(np.percentile(sdual, 50)),
        "soft_box_dual_max": float(sdual.max()),
        "box_slack_penalty": w,
        "soft_box_dual_saturation": float(sdual.max() / w) if w else None,
    }
    print(json.dumps(summary, indent=2))
    summary["solves_per_s"] = args.n / t_total
    summary["strict"] = violation_counts(records, planner.limits, planner.margins)
    summary["reference"] = violation_counts_reference(records, planner.limits)
    summary["magnitudes"] = violation_magnitudes(
        records, planner.limits, planner.margins
    )
    summary["accuracy"] = accuracy_stats(records)
    print("\nviolation counts, STRICT convention (margin-scaled boxes), of",
          args.n, "trajectories:")
    print(json.dumps(summary["strict"], indent=2))
    print("\nviolation counts, REFERENCE convention (full limits, notebook"
          " cell-3 semantics — directly comparable to benchmark_analysis.ipynb):")
    print(json.dumps(summary["reference"], indent=2))
    print("\nviolation magnitudes (worst overshoot per trajectory):")
    print(json.dumps(summary["magnitudes"], indent=2))
    print("\naccuracy:")
    print(json.dumps(summary["accuracy"], indent=2))
    return summary


if __name__ == "__main__":
    main()
