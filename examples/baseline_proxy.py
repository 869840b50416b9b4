#!/usr/bin/env python
"""Serial single-problem CPU baseline proxy for `vs_baseline`.

The C++ reference publishes no performance numbers and cannot be built on
this image (polyMPC submodule not vendored, no pinocchio/ruckig —
BASELINE.md). As the closest measurable stand-in, this script runs the SAME
workload bench.py measures — chained benchmark states, jerk-limited warm
start, 2 SQP x <=700 boxADMM iterations at eps 1e-3 (motionPlanner.cpp:15-19)
— as SERIAL batch-1 solves on a single CPU process (float64, like the
reference's double), and reports solves/s and per-solve latency.

This measures the same algorithmic budget the reference executes per solve
(the reference's per-iteration work is a sparse 400-var KKT solve; ours is
dense-batched) so it is a *proxy*, not a reproduction — see BASELINE.md for
how the resulting figure is used.

Usage:  JAX_PLATFORMS=cpu python examples/baseline_proxy.py [--n 32]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32, help="number of serial solves")
    ap.add_argument("--x64", action="store_true", default=True)
    args = ap.parse_args()

    from mpc_motion_planner_tpu.config import setup

    setup("cpu", x64=True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_motion_planner_tpu.bench.harness import chain_states
    from mpc_motion_planner_tpu.ops.qp import QPSettings
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=QPSettings(backend="xla"),
        dtype=jnp.float64,
    )

    @jax.jit
    def solve_one(cur, tgt):
        sol = planner.solve(cur, tgt)
        return sol.z, sol.violation

    key = jax.random.PRNGKey(0)
    current, target = chain_states(planner, key, args.n)

    # compile once on the first pair
    jax.block_until_ready(solve_one(current[:1], target[:1]))

    times = []
    for i in range(args.n):
        t0 = time.perf_counter()
        jax.block_until_ready(solve_one(current[i : i + 1], target[i : i + 1]))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)

    result = {
        "metric": "serial_cpu_solves_per_s",
        "value": round(float(args.n / times.sum()), 3),
        "unit": "solves/s",
        "n": args.n,
        "p50_latency_ms": round(float(np.median(times) * 1e3), 3),
        "p95_latency_ms": round(float(np.percentile(times, 95) * 1e3), 3),
        "dtype": "float64",
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
