#!/usr/bin/env python
"""Analysis reporting — the planner's equivalent of the reference's plotly
notebooks (/root/reference/analysis/data_analysis.ipynb and
benchmark_analysis.ipynb), consuming the same text-file formats the
examples write.

Usage:
    # single-trajectory view (after examples/offline_trajectory.py):
    python examples/analysis.py trajectory [--in analysis/optimal_solution.txt]
        [--outdir analysis]

    # benchmark summary (after examples/benchmark.py):
    python examples/analysis.py benchmark [--in analysis/benchmark_data.txt]
        [--outdir analysis]

Saves PNG figures and prints the violation/accuracy tables.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["trajectory", "benchmark"])
    ap.add_argument("--in", dest="path", default=None)
    ap.add_argument("--outdir", default="analysis")
    ap.add_argument("--margins", type=float, nargs=5,
                    default=[0.8, 0.8, 0.6, 0.9, 0.1])
    args = ap.parse_args()

    from mpc_motion_planner_tpu.config import setup

    setup("cpu")

    from mpc_motion_planner_tpu.bench import plots
    from mpc_motion_planner_tpu.bench.analysis import (
        accuracy_stats,
        violation_counts,
        violation_counts_reference,
    )
    from mpc_motion_planner_tpu.models.panda import make_panda_limits, make_panda_model
    from mpc_motion_planner_tpu.planner import Margins
    from mpc_motion_planner_tpu.utils.io import read_benchmark_records

    limits = make_panda_limits()
    margins = Margins(*args.margins)
    os.makedirs(args.outdir, exist_ok=True)

    if args.mode == "trajectory":
        path = args.path or "analysis/optimal_solution.txt"
        target, rk, mpc = plots.load_optimal_solution(path)
        plots.plot_trajectory_grid(
            target, rk, mpc, limits, margins,
            save_path=os.path.join(args.outdir, "trajectory_grid.png"),
        )
        model = make_panda_model()
        plots.plot_ee_path(
            model, model.frame("panda_tool"), rk, mpc,
            save_path=os.path.join(args.outdir, "ee_path.png"),
        )
        print(f"saved trajectory_grid.png + ee_path.png to {args.outdir}/")
    else:
        path = args.path or "analysis/benchmark_data.txt"
        records = read_benchmark_records(path)
        plots.plot_extrema_scatter(
            records, limits, margins,
            save_path=os.path.join(args.outdir, "extrema_scatter.png"),
        )
        plots.plot_error_cdf(
            records, save_path=os.path.join(args.outdir, "error_cdf.png"),
        )
        print(f"saved extrema_scatter.png + error_cdf.png to {args.outdir}/")
        print("\nviolation counts (strict, margin-scaled boxes):")
        print(json.dumps(violation_counts(records, limits, margins), indent=2))
        print("\nviolation counts (reference notebook cell-3 convention,"
              " full limits):")
        print(json.dumps(violation_counts_reference(records, limits), indent=2))
        print("\naccuracy:")
        print(json.dumps(accuracy_stats(records), indent=2))


if __name__ == "__main__":
    main()
