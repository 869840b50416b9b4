#!/usr/bin/env python
"""Convergence diagnostic for the structured QP backend on the chained
benchmark workload.

Replays the QP subproblems exactly as ops/sqp.py poses them (warm start,
prox-soft nonlinear inequality rows, dual warm starts between SQP steps)
and records per-problem convergence, iteration counts and final residuals
for a few settings variants, to answer:

* where do the unconverged QPs sit (primal vs dual residual)?
* does adaptive rho / kkt refinement / a different base rho fix them?

Runs on CPU in f32 (the shipping precision) regardless of the available
accelerator: it reports iteration counts and residuals, not times.

Usage: python experiments/conv_diag.py [batch] [variant ...]
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from mpc_motion_planner_tpu.bench.harness import chain_states
from mpc_motion_planner_tpu.ops import structure
from mpc_motion_planner_tpu.ops.qp import QPSettings
from mpc_motion_planner_tpu.ops.qp_structured import solve_box_qp_structured
from mpc_motion_planner_tpu.ops.sqp import (
    _line_search,
    constraint_violation,
    hessian_regularization_diag,
)
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

VARIANTS = {
    "base": dict(),
    "refine1": dict(kkt_refine=1),
    "rho_adapt100": dict(rho_update_every=100, kkt_refine=1),
    "rho_adapt50": dict(rho_update_every=50, kkt_refine=1),
    "rho_adapt25": dict(rho_update_every=25, kkt_refine=1),
    "rho0.5": dict(rho=0.5, kkt_refine=1),
    "rho0.02": dict(rho=0.02, kkt_refine=1),
    "eq300": dict(rho_eq_scale=300.0, kkt_refine=1),
    "it1400_r1": dict(max_iter=1400, kkt_refine=1),
    # l1 elastic variable box (SQPSettings.box_slack_penalty): the fix the
    # base diagnosis points at — the unconverged QPs plateau on the U-box
    # primal residual (structurally primal-infeasible linearizations).
    "boxslack3": dict(box_slack=3.0),
    "boxslack10": dict(box_slack=10.0),
    "boxslack30": dict(box_slack=30.0),
    "boxslack10_r1": dict(box_slack=10.0, kkt_refine=1),
}


def qp_stats(planner, cur, tgt, qp_kw):
    """Run the full 2-step SQP (mirroring ops/sqp._sqp_solve_impl with the
    structured backend), returning per-step QP diagnostics + violation."""
    ocp = planner.ocp
    settings = planner.sqp_settings
    kw = dict(backend="structured", rho_update_every=0)
    kw.update(qp_kw)
    box_slack = kw.pop("box_slack", 0.0)
    qp_settings = QPSettings(**kw)

    traj = planner.plan_warm_start(cur, tgt)
    z0 = planner.warm_start_vector(traj)
    bounds = planner.nlp_bounds(cur, tgt, None)

    B = z0.shape[0]
    dt = z0.dtype
    n = ocp.num_var
    m = ocp.num_eq + ocp.num_ineq

    lb_var = jnp.broadcast_to(bounds.lb_var, z0.shape)
    ub_var = jnp.broadcast_to(bounds.ub_var, z0.shape)
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))
    if settings.slack_penalty > 0:
        soft_c = jnp.zeros((B, m), dt).at[:, ocp.num_eq :].set(
            settings.slack_penalty
        )
    else:
        soft_c = None
    if box_slack > 0:
        n_s, nx_, nu_ = ocp.num_nodes, ocp.nx, ocp.nu
        wx = jnp.zeros((n,), dt)
        wx = wx.at[nx_ : (n_s - 1) * nx_].set(box_slack)
        wx = wx.at[n_s * nx_ : n_s * (nx_ + nu_)].set(box_slack)
        soft_x = jnp.broadcast_to(wx, (B, n))
    else:
        soft_x = None

    @jax.jit
    def run(z0):
        z = z0
        lam_c = jnp.zeros((B, m), dt)
        lam_x = jnp.zeros((B, n), dt)
        out = []
        with jax.default_matmul_precision("highest"):
            for _ in range(settings.max_iter):
                c_eq = jax.vmap(ocp.eq_residual)(z)
                g = jax.vmap(ocp.ineq_residual)(z)
                sa = structure.build_structured_A(ocp, z)
                h = jax.vmap(ocp.cost_gradient)(z)
                P_diag = hessian_regularization_diag(
                    ocp, (B,), dt, settings.reg_eps
                )
                lc = jnp.concatenate([-c_eq, lb_g - g], axis=-1)
                uc = jnp.concatenate([-c_eq, ub_g - g], axis=-1)
                lx = lb_var - z
                ux = ub_var - z
                qp = solve_box_qp_structured(
                    ocp, sa, P_diag, h, lc, uc, lx, ux, qp_settings,
                    yc0=lam_c, yx0=lam_x, soft_c=soft_c, soft_x=soft_x,
                )
                # split the primal infeasibility of the returned iterate by
                # row group: eq (defect) rows vs ineq rows vs variable box
                from mpc_motion_planner_tpu.ops.structure import apply_A

                Ax = apply_A(ocp, sa, qp.x)
                v_eq = jnp.max(
                    jnp.abs(Ax[:, : ocp.num_eq] - lc[:, : ocp.num_eq]), axis=-1
                )
                gi = Ax[:, ocp.num_eq :]
                v_g = jnp.max(
                    jnp.maximum(gi - uc[:, ocp.num_eq :], 0.0)
                    + jnp.maximum(lc[:, ocp.num_eq :] - gi, 0.0),
                    axis=-1,
                )
                bx = jnp.maximum(qp.x - ux, 0.0) + jnp.maximum(lx - qp.x, 0.0)
                v_x = jnp.max(bx, axis=-1)
                # split the box violation by variable group
                n_s, nx_, nu_ = ocp.num_nodes, ocp.nx, ocp.nu
                bX = bx[:, : n_s * nx_].reshape(B, n_s, nx_)
                v_x0 = jnp.max(bX[:, 0], axis=-1)
                v_xT = jnp.max(bX[:, -1], axis=-1)
                v_xm = jnp.max(bX[:, 1:-1].reshape(B, -1), axis=-1)
                v_u = jnp.max(bx[:, n_s * nx_ : n_s * (nx_ + nu_)], axis=-1)
                v_p = bx[:, n_s * (nx_ + nu_)]
                out.append(
                    (qp.converged, qp.iterations, qp.prim_residual,
                     qp.dual_residual, v_eq, v_g, v_x,
                     v_x0, v_xm, v_xT, v_u, v_p)
                )
                d = qp.x
                y_box = qp.y_box
                mu = jnp.maximum(
                    jnp.max(jnp.abs(qp.y_constraints), axis=-1),
                    jnp.max(jnp.abs(y_box), axis=-1),
                )
                alpha = _line_search(ocp, bounds, z, d, h, mu, settings)
                z = z + alpha[:, None] * d
                lam_c = lam_c + alpha[:, None] * (qp.y_constraints - lam_c)
                lam_x = lam_x + alpha[:, None] * (y_box - lam_x)
            z = jnp.clip(z, lb_var, ub_var)
            viol = constraint_violation(ocp, bounds, z)
        return out, viol

    return run(z0)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    names = sys.argv[2:] or ["base", "refine1", "rho_adapt50"]
    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1))
    key = jax.random.PRNGKey(0)
    cur, tgt = chain_states(planner, key, B)

    for name in names:
        kw = dict(VARIANTS[name])
        t0 = time.perf_counter()
        out, viol = jax.block_until_ready(qp_stats(planner, cur, tgt, kw))
        wall = time.perf_counter() - t0
        print(f"== {name} (B={B}, compile+run {wall:.1f}s) ==", flush=True)
        for step, (conv, iters, rp, rd, v_eq, v_g, v_x,
                   v_x0, v_xm, v_xT, v_u, v_p) in enumerate(out):
            conv = np.asarray(conv)
            iters = np.asarray(iters)
            rp, rd = np.asarray(rp), np.asarray(rd)
            v_eq, v_g, v_x = np.asarray(v_eq), np.asarray(v_g), np.asarray(v_x)
            bad = ~conv
            print(
                f"  step{step}: conv={conv.mean():.3f} "
                f"iters p50/p90/max={np.percentile(iters, 50):.0f}/"
                f"{np.percentile(iters, 90):.0f}/{iters.max()} "
            )
            if bad.any():
                print(
                    f"    unconverged: n={bad.sum()} "
                    f"rp p50/max={np.median(rp[bad]):.2e}/{rp[bad].max():.2e} "
                    f"rd p50/max={np.median(rd[bad]):.2e}/{rd[bad].max():.2e}"
                )
                print(
                    f"    iterate infeas (max over rows, p50/max over bad): "
                    f"eq={np.median(v_eq[bad]):.2e}/{v_eq[bad].max():.2e} "
                    f"ineq={np.median(v_g[bad]):.2e}/{v_g[bad].max():.2e} "
                    f"box={np.median(v_x[bad]):.2e}/{v_x[bad].max():.2e}"
                )
                grp = {
                    "X0": v_x0, "Xmid": v_xm, "XT": v_xT, "U": v_u, "p": v_p,
                }
                parts = " ".join(
                    f"{k}={np.median(np.asarray(v)[bad]):.2e}/"
                    f"{np.asarray(v)[bad].max():.2e}"
                    for k, v in grp.items()
                )
                print(f"    box split (p50/max over bad): {parts}")
        viol = np.asarray(viol)
        print(f"  violation p50/p90/max={np.median(viol):.3f}/"
              f"{np.percentile(viol, 90):.2f}/{viol.max():.2f}", flush=True)


if __name__ == "__main__":
    main()
