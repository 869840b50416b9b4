#!/usr/bin/env python
"""Receding-horizon hot restarts — the solve_trajectory(false) use case
(/root/reference/mpc_solver/motionPlanner.cpp:177-208): after the first
OTG-seeded solve, each re-plan is seeded from the previous SOLUTION with
the endpoints pinned (Solution.reseed_guess) and skips OTG planning
entirely. The target stays fixed while the start advances along the
trajectory, so the previous solution is a near-exact guess: hot solves
converge in fewer QP iterations with a monotonically shrinking
time-to-go.

Usage:
    python examples/hot_restart.py [--steps 6] [--batch 64]
        [--advance 0.1] [--platform gpu|cpu] [--x64]

Prints a per-step table (QP iterations, convergence, violation, t_f) for
the hot-restart chain and, for comparison, the same receding chain with a
fresh OTG warm start at every step.

Note the measured scope (KERNELS.md, hot restarts): re-seeding helps when the target is UNCHANGED (this receding pattern);
across a changed target the old trajectory has the wrong shape and an OTG
re-plan is the better seed — which is why the batch benchmark keeps
per-solve OTG warm starts.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--advance", type=float, default=0.1,
                    help="fraction of the remaining horizon to advance per step")
    ap.add_argument("--platform", default=None, choices=[None, "gpu", "cpu"])
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from mpc_motion_planner_tpu.config import setup, shipping_qp_settings

    platform = setup(args.platform, args.x64)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_motion_planner_tpu.bench.harness import sample_benchmark_targets
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=shipping_qp_settings(platform),
    )
    nq = planner.ocp.nq
    key = jax.random.PRNGKey(args.seed)
    q_t, qd_t = sample_benchmark_targets(planner, key, 2 * args.batch)
    cur = jnp.concatenate([q_t[: args.batch], qd_t[: args.batch] * 0], -1)
    tgt = jnp.concatenate([q_t[args.batch :], qd_t[args.batch :]], -1)

    @jax.jit
    def solve_fresh(cur, tgt):
        return planner.solve(cur, tgt)

    @jax.jit
    def solve_hot(cur, tgt, z_prev, lam_c, lam_x):
        nx = planner.ocp.nx
        n0 = (planner.ocp.num_nodes - 1) * nx
        z0 = z_prev.at[..., :nx].set(cur).at[..., n0 : n0 + nx].set(tgt)
        return planner.solve(cur, tgt, z0=z0, lam_c0=lam_c, lam_x0=lam_x)

    @jax.jit
    def advance(sol_z, frac):
        from mpc_motion_planner_tpu.ops.collocation import interpolate

        nx = planner.ocp.nx
        X = sol_z[:, : planner.ocp.num_nodes * nx].reshape(
            -1, planner.ocp.num_nodes, nx
        )
        return jax.vmap(lambda Xb: interpolate(planner.ocp.coll, Xb, frac))(X)

    frac = jnp.asarray(args.advance, cur.dtype)
    for arm in ("hot", "fresh"):
        print(f"\n=== receding chain, {arm} re-seeding ===")
        print(f"{'step':>4} {'wall_ms':>8} {'qp_iters':>12} {'conv':>6} "
              f"{'viol_p50':>9} {'tf_p50':>7}")
        sol = jax.block_until_ready(solve_fresh(cur, tgt))
        if arm == "hot":  # compile outside the timed loop
            jax.block_until_ready(solve_hot(cur, tgt, sol.z, sol.lam_c, sol.lam_x))
            sol = jax.block_until_ready(solve_fresh(cur, tgt))
        for j in range(args.steps):
            c = advance(sol.z, frac) if j else cur
            t0 = time.perf_counter()
            if arm == "hot" and j:
                sol = jax.block_until_ready(
                    solve_hot(c, tgt, sol.z, sol.lam_c, sol.lam_x)
                )
            else:
                sol = jax.block_until_ready(solve_fresh(c, tgt))
            dt = 1e3 * (time.perf_counter() - t0)
            it = np.asarray(sol.qp_iterations)
            print(f"{j:>4} {dt:>8.1f} "
                  f"{'/'.join(str(int(it[:, s].mean())) for s in range(it.shape[1])):>12} "
                  f"{float(np.asarray(sol.qp_converged).mean()):>6.3f} "
                  f"{float(np.median(np.asarray(sol.violation))):>9.3f} "
                  f"{float(np.median(np.asarray(sol.final_time))):>7.3f}")


if __name__ == "__main__":
    main()
