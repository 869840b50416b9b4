#!/usr/bin/env python
"""Single random trajectory demo — the batched planner's equivalent of
/root/reference/examples/offline_trajectory.cpp.

Samples a random feasible start and goal (margins 0.9/0.9/0.5/0.9/0.1,
offline_trajectory.cpp:9), solves the minimum-time OCP with the
jerk-limited warm start, and writes `analysis/optimal_solution.txt` in the
reference's 29-column format (target line + 201-point warm-start block +
201-point MPC block).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=[None, "gpu", "cpu"])
    ap.add_argument("--x64", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="analysis/optimal_solution.txt")
    args = ap.parse_args(argv)

    from mpc_motion_planner_tpu.config import setup

    setup(args.platform, args.x64)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner
    from mpc_motion_planner_tpu.utils.io import write_optimal_solution

    planner = MotionPlanner(margins=Margins(0.9, 0.9, 0.5, 0.9, 0.1))

    key = jax.random.PRNGKey(args.seed)
    k1, k2 = jax.random.split(key)
    q0, v0 = planner.sample_random_state(k1)
    q1, v1 = planner.sample_random_state(k2)

    # clamp target task velocity (offline_trajectory.cpp:26-41)
    task = planner.forward_velocities(q1, v1)
    lin = float(jnp.linalg.norm(task[:3]))
    if lin > planner.limits.max_linear_velocity:
        v1 = v1 * 0.9 * planner.limits.max_linear_velocity / lin
        print(f"Linear Vel: {lin} corrected")
    task = planner.forward_velocities(q1, v1)
    ang = float(jnp.linalg.norm(task[3:]))
    if ang > planner.limits.max_angular_velocity:
        v1 = v1 * 0.9 * planner.limits.max_angular_velocity / ang
        print(f"Angular Vel: {ang} corrected")

    # feasibility check (offline_trajectory.cpp:46-48)
    if int(planner.check_state_in_bounds(q0, v0)) or int(
        planner.check_state_in_bounds(q1, v1)
    ):
        raise RuntimeError("Initial or final state outside bounds")

    current = jnp.concatenate([q0, v0])[None]
    target = jnp.concatenate([q1, v1])[None]
    print("Target:")
    print(np.asarray(q1))
    print(np.asarray(v1))

    n = 200

    @jax.jit
    def plan(current, target):
        sol = planner.solve(current, target)
        return sol, planner.sample_warm_start(sol.warm_start, n), sol.sample(n)

    sol, rk, mpc = plan(current, target)
    print("final time:", float(sol.final_time[0]), "s  (warm start:",
          float(sol.warm_start.duration[0]), "s)")
    print("constraint violation:", float(sol.violation[0]))

    unbatch = lambda tup: tuple(np.asarray(x[0]) for x in tup)
    write_optimal_solution(args.out, np.asarray(target[0]), unbatch(rk), unbatch(mpc))
    print("wrote", args.out)
    return sol


if __name__ == "__main__":
    main()
