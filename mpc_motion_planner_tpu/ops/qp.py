"""Batched OSQP-style boxADMM quadratic-program solver.

Batched replacement for polyMPC's ``boxADMM<VAR_SIZE, NUM_EQ+NUM_INEQ>``
(/root/reference/mpc_solver/motionPlanner.hpp:10-11): ADMM for QPs with both
general constraint rows  l_c <= A x <= u_c  and separate variable boxes
l_x <= x <= u_x (identity rows handled implicitly, so the KKT system stays
n x n). Reference solver budget: max_iter=700, eps_abs=eps_rel=1e-3
(motionPlanner.cpp:16-19).

Design decisions:
* Natively batched: every operand carries a leading batch axis; ONE
  ``lax.while_loop`` runs until all batch elements converge or the
  iteration cap is hit. Elements freeze at their own convergence point
  (masked updates), reproducing per-problem termination semantics of the
  serial reference while the batch keeps executing.
* The ADMM linear system M = P + sigma I + rho_x I + A^T diag(rho_c) A is
  inverted ONCE per solve (batched); each iteration is then pure batched
  GEMV work that XLA fuses — no per-iteration factorizations.
* Per-row rho: rows with l == u (equality rows — the collocation defects)
  get ``rho * rho_eq_scale`` (OSQP convention).
* P may be a diagonal (B, n) — the planner's case: its Lagrangian Hessian
  is identically zero (second-order constraint derivatives return zeros,
  robot_ocp.hpp:165-168) and Gershgorin regularization turns it into a
  small positive diagonal — or a general dense (B, n, n) symmetric PSD
  matrix, matching polyMPC's boxADMM which takes an arbitrary convex
  Hessian (motionPlanner.hpp:10-11, hessian_update_impl hook at
  polympc_redef.hpp:124-128). Dense P is supported on the XLA backend
  only; the structured backend raises a clear error.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class QPSettings:
    max_iter: int = dataclasses.field(default=700, metadata={"static": True})
    check_every: int = dataclasses.field(default=25, metadata={"static": True})
    eps_abs: float = dataclasses.field(default=1e-3, metadata={"static": True})
    eps_rel: float = dataclasses.field(default=1e-3, metadata={"static": True})
    rho: float = dataclasses.field(default=0.1, metadata={"static": True})
    # Equality-row rho multiplier (OSQP convention 1e3). The stiff scaling
    # amplifies f32 KKT-inverse rounding into ADMM stalls (f32: 23% of the
    # chained-benchmark QPs converge in 700 iters; f64: 78% in ~300) —
    # lowering it helps f32 convergence but degrades the feasible-case
    # defect residual (easy-solve violation 0.05 -> 1.5 at eq=30). The fix
    # is kkt_refine=1, which restores f64-like convergence at f32 while
    # keeping the tight equality weighting.
    rho_eq_scale: float = dataclasses.field(default=1e3, metadata={"static": True})
    sigma: float = dataclasses.field(default=1e-6, metadata={"static": True})
    alpha: float = dataclasses.field(default=1.6, metadata={"static": True})
    # Ruiz equilibration sweeps (0 disables). The reference's boxADMM runs
    # unscaled (its `scaling` knob is commented out, motionPlanner.cpp:21);
    # the NLP rows span ~2 orders of magnitude so SOME scaling is
    # load-bearing for convergence within the 700-iteration budget — but
    # fewer sweeps converge BETTER on the chained workload at B=2048 (QP
    # convergence 0.9990 at 2 sweeps, 0.9983 at 4, 0.9941 at 6, 0.9939 at
    # 10, violation unchanged; KERNELS.md): full equilibration distorts
    # the effective per-row rho pattern more than it helps conditioning.
    ruiz_iters: int = dataclasses.field(default=2, metadata={"static": True})
    # OSQP-style adaptive rho: per-problem rescale every `rho_update_every`
    # iterations by sqrt(prim/dual residual ratio) (0 disables).
    rho_update_every: int = dataclasses.field(default=100, metadata={"static": True})
    rho_min: float = dataclasses.field(default=1e-6, metadata={"static": True})
    rho_max: float = dataclasses.field(default=1e6, metadata={"static": True})
    # "xla": dense batched einsum iterations (the plain reference; the
    # only backend that takes a dense P). "structured": matrix-free
    # applies + banded-arrow KKT factorization (ops/qp_structured.py) —
    # the shipping backend on the GPU and the CPU (config.qp_backend).
    backend: str = dataclasses.field(default="xla", metadata={"static": True})
    # Straggler-rescue budget: EXTRA ADMM iterations beyond max_iter,
    # effectively granted only to problems still unconverged near the
    # scheduled budget's end. It extends the masked while_loop cap
    # (converged problems are frozen — identical results, linear extra
    # wall time). The reference has no equivalent (fixed 700,
    # motionPlanner.cpp:16-19); this exists because the residual ~0.6%
    # non-convergence is slow DUAL convergence near tolerance
    # (KERNELS.md), which extra iterations do fix — unlike the
    # pre-elastic-box infeasibility plateau, which they provably did not.
    # `QPSolution.iterations` may exceed max_iter for rescued problems.
    rescue_iters: int = dataclasses.field(default=0, metadata={"static": True})
    # KKT factorization scheme for the explicit M^-1: "lu" (jnp.linalg.inv)
    # or "cholesky" (M is SPD by construction: diag(P) + sigma I + rho_x I
    # + A^T diag(rho_c) A with all weights > 0) — Cholesky + two triangular
    # solves + a GEMM, which keeps more of the work in matrix products than LU's
    # pivoted panel factorization.
    kkt_factor: str = dataclasses.field(default="lu", metadata={"static": True})
    # Iterative-refinement steps on each x-update's KKT solve:
    # xt += M^-1 (rhs - M xt), with M xt applied in factored form
    # ((P + sigma + rho_x) xt + A^T (rho_c (A xt))) so only A is needed.
    # At f32 the explicit inverse carries cond(M)-amplified rounding that
    # stalls ADMM on stiff equality scalings (measured: f32 eq=1e3
    # converges 3-25% of chain QPs vs 78% at f64); one refinement step
    # recovers f64-like convergence for ~2x per-iteration matvec cost.
    kkt_refine: int = dataclasses.field(default=0, metadata={"static": True})


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class QPSolution:
    x: jax.Array  # (B, n) primal
    y_constraints: jax.Array  # (B, m) duals of the A-rows
    y_box: jax.Array  # (B, n) duals of the variable box
    converged: jax.Array  # (B,) bool
    # Iteration of convergence, or the cap for unconverged problems.
    iterations: jax.Array  # (B,) int32
    prim_residual: jax.Array  # (B,)
    dual_residual: jax.Array  # (B,)


def _rho_pattern(lb, ub, settings: QPSettings):
    """Per-row rho multiplier: equality rows get rho_eq_scale."""
    eq = jnp.abs(ub - lb) < 1e-12
    return jnp.where(eq, settings.rho_eq_scale, 1.0).astype(lb.dtype)


# Finite stand-in for "hard row" in the soft-threshold array: a normal f32,
# so the thr = _HARD / rho quotient never overflows to inf.
_HARD = 1e20


def _soft_prox(v, lb, ub, thr):
    """Prox of thr-scaled l1 box-distance: the z-update for SOFT rows.

    Solves  min_z  w*dist_[lb,ub](z) + (rho/2)(z - v)^2  with thr = w/rho:
    inside the box -> v; outside -> shrink toward the box by thr, saturating
    at the box edge. thr = _HARD/rho reduces exactly to jnp.clip(v, lb, ub)
    (hard projection): the shrink is never clipped for any representable v.

    This is the slack-free form of an exact l1 elastic: a row with penalty
    weight w behaves identically to adding slack variables s+/s- >= 0 with
    linear cost w (tests/test_qp.py oracle), and the row's dual is
    automatically bounded by w — infeasible QPs can no longer blow up the
    ADMM duals of soft rows.
    """
    box = jnp.clip(v, lb, ub)
    return v - jnp.clip(v - box, -thr, thr)


def _pmul(Ps, x):
    """P @ x for diagonal (B, n) or dense (B, n, n) P."""
    if Ps.ndim == 3:
        return jnp.einsum("bij,bj->bi", Ps, x)
    return Ps * x


def _ruiz_equilibrate(A, iters: int):
    """Ruiz equilibration: diagonal D (cols) and E (rows) so the scaled
    E A D has rows/cols with ~unit inf-norms. Returns (D, E), each >= tiny."""
    B, m, n = A.shape
    dt = A.dtype
    D = jnp.ones((B, n), dt)
    E = jnp.ones((B, m), dt)
    def scale(norm):
        # leave all-zero rows/cols untouched instead of blowing up
        return jnp.where(norm > 1e-10, 1.0 / jnp.sqrt(jnp.maximum(norm, 1e-10)), 1.0)

    for _ in range(iters):
        As = E[:, :, None] * A * D[:, None, :]
        cnorm = jnp.max(jnp.abs(As), axis=1)  # (B, n)
        rnorm = jnp.max(jnp.abs(As), axis=2)  # (B, m)
        D = D * scale(cnorm)
        E = E * scale(rnorm)
    return D, E


def solve_box_qp(
    P_diag,
    q,
    A,
    lc,
    uc,
    lx,
    ux,
    settings: QPSettings = QPSettings(),
    x0=None,
    yc0=None,
    yx0=None,
    soft_c=None,
    soft_x=None,
    max_iter=None,
) -> QPSolution:
    """Solve a batch of box QPs:  min 1/2 x^T P x + q^T x
    s.t. lc <= A x <= uc,  lx <= x <= ux.

    Shapes: q, lx, ux: (B, n); A: (B, m, n); lc, uc: (B, m); P_diag is a
    diagonal (B, n) or a dense symmetric PSD (B, n, n) Hessian (dense P:
    XLA backend only). Warm starts and returned solutions/duals are in
    UNSCALED units; termination residuals are evaluated in unscaled units
    as well, so eps_abs/eps_rel retain their reference meaning under
    equilibration.

    soft_c: optional (B, m) per-row l1 penalty weights, or one (1, m) row
    broadcast over the batch. Rows with soft_c > 0 are SOFT: their box may
    be violated at linear cost soft_c[i] per unit (exact l1 elastic,
    implemented as a prox in the z-update — see :func:`_soft_prox`); rows
    with 0 stay hard. Soft-row
    duals are bounded by their weight, so primal-infeasible QPs cannot
    diverge through those rows.

    soft_x: optional (B, n) (or (1, n)) per-VARIABLE l1 penalty weights:
    the same elastic relaxation applied to the variable box lx <= x <= ux
    (SNOPT-style elastic mode on the bound rows). The planner uses it on
    the control/interior-state boxes: a warm start whose defect residual
    cannot be corrected within the pinned endpoints without exceeding the
    margin-scaled acceleration box makes the linearized QP structurally
    primal-infeasible — no iteration budget or rho schedule converges it
    (measured, experiments/conv_diag.py; the unconverged ~18% of chain QPs
    all plateau on the U-box primal residual). Softening those rows
    restores convergence while the exact-penalty property keeps feasible
    solves bitwise-unaffected whenever the weight exceeds the row's
    optimal box dual.

    max_iter: optional iteration cap in place of settings.max_iter. It may
    be a traced integer, so one compiled solver serves several caps (the
    SQP's per-step budgets).
    """
    B, m, n = A.shape
    dt = q.dtype

    if P_diag.ndim == 3 and settings.backend != "xla":
        raise ValueError(
            "dense P is only supported on the 'xla' backend; the "
            "structured backend exploits diagonal P (the planner's "
            "regularized zero Hessian)."
        )
    # A float32 matmul at default precision may run in TF32 on the GPU,
    # which destroys ADMM convergence (the KKT inverse and the iteration
    # matvecs need full f32). Force full precision for everything traced
    # inside the solver.
    with jax.default_matmul_precision("highest"):
        return _solve_box_qp_impl(
            P_diag, q, A, lc, uc, lx, ux, settings, x0, yc0, yx0, soft_c,
            soft_x, max_iter,
        )


def _solve_box_qp_impl(
    P_diag, q, A, lc, uc, lx, ux, settings, x0, yc0, yx0, soft_c=None,
    soft_x=None, max_iter=None,
) -> QPSolution:
    B, m, n = A.shape
    dt = q.dtype
    cap = settings.max_iter if max_iter is None else max_iter

    # ---- Ruiz equilibration (scaled problem solved internally) ----
    if settings.ruiz_iters > 0:
        D, E = _ruiz_equilibrate(A, settings.ruiz_iters)
    else:
        D = jnp.ones((B, n), dt)
        E = jnp.ones((B, m), dt)
    As = E[:, :, None] * A * D[:, None, :]
    dense_P = P_diag.ndim == 3
    if dense_P:
        Ps = D[:, :, None] * P_diag * D[:, None, :]
    else:
        Ps = D * P_diag * D
    qs = D * q
    lcs, ucs = E * lc, E * uc
    lxs, uxs = lx / D, ux / D

    pat_c = _rho_pattern(lc, uc, settings)  # (B, m)
    pat_x = _rho_pattern(lx, ux, settings)  # (B, n)
    # scaled soft-row penalty weights (hard rows get the finite stand-in)
    if soft_c is None:
        soft_s = jnp.full((B, m), _HARD, dt)
    else:
        soft_c = soft_c.astype(dt)
        soft_s = jnp.where(soft_c > 0, soft_c / E, _HARD)
    # variable-box weights scale by D (unscaled box distance = D * scaled)
    if soft_x is None:
        soft_xs = jnp.full((B, n), _HARD, dt)
    else:
        soft_x = soft_x.astype(dt)
        soft_xs = jnp.where(soft_x > 0, soft_x * D, _HARD)
    sigma = jnp.asarray(settings.sigma, dt)
    alpha = jnp.asarray(settings.alpha, dt)
    rho0 = jnp.full((B,), settings.rho, dt)

    def factor(rho_s):
        rc = rho_s[:, None] * pat_c
        rx = rho_s[:, None] * pat_x
        M = jnp.einsum("bmi,bm,bmj->bij", As, rc, As)
        if dense_P:
            M = M + Ps + jax.vmap(jnp.diag)(sigma + rx)
        else:
            M = M + jax.vmap(jnp.diag)(Ps + sigma + rx)
        if settings.kkt_factor == "cholesky":
            L = jnp.linalg.cholesky(M)
            eye = jnp.broadcast_to(jnp.eye(n, dtype=dt), M.shape)
            Linv = jax.lax.linalg.triangular_solve(
                L, eye, left_side=True, lower=True
            )
            M_chol = jnp.einsum("bki,bkj->bij", Linv, Linv)
            # f32 breakdown guard: at rho_eq_scale=1e3 cond(M) can exceed
            # what Cholesky tolerates in f32 and jnp.linalg.cholesky
            # silently returns NaN. Fall back to the LU inverse for those problems (cond keeps
            # the LU cost off the common all-finite path).
            bad = ~jnp.all(jnp.isfinite(M_chol), axis=(1, 2), keepdims=True)
            return jax.lax.cond(
                jnp.any(bad),
                lambda _: jnp.where(bad, jnp.linalg.inv(M), M_chol),
                lambda _: M_chol,
                None,
            )
        return jnp.linalg.inv(M)

    M_inv0 = factor(rho0)

    x = jnp.zeros((B, n), dt) if x0 is None else x0 / D
    yc = jnp.zeros((B, m), dt) if yc0 is None else yc0 / E
    yx = jnp.zeros((B, n), dt) if yx0 is None else yx0 * D

    zc = jnp.clip(jnp.einsum("bmn,bn->bm", As, x), lcs, ucs)
    zx = jnp.clip(x, lxs, uxs)

    def residuals(x, zc, zx, yc, yx):
        """Unscaled OSQP residuals + convergence test + rho ratio."""
        Ax = jnp.einsum("bmn,bn->bm", As, x)
        # unscale: rows by 1/E, variables by D, duals by E (c) / 1/D (x)
        r_prim_c = jnp.max(jnp.abs((Ax - zc) / E), axis=-1)
        r_prim_x = jnp.max(jnp.abs(D * (x - zx)), axis=-1)
        r_prim = jnp.maximum(r_prim_c, r_prim_x)
        Aty = jnp.einsum("bmn,bm->bn", As, yc)
        Px = _pmul(Ps, x)
        r_dual = jnp.max(jnp.abs((Px + qs + Aty + yx) / D), axis=-1)
        scale_p = jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(Ax / E), axis=-1), jnp.max(jnp.abs(zc / E), axis=-1)
            ),
            jnp.maximum(
                jnp.max(jnp.abs(D * x), axis=-1), jnp.max(jnp.abs(D * zx), axis=-1)
            ),
        )
        scale_d = jnp.maximum(
            jnp.maximum(
                jnp.max(jnp.abs(Px / D), axis=-1),
                jnp.max(jnp.abs(qs / D), axis=-1),
            ),
            jnp.maximum(
                jnp.max(jnp.abs(Aty / D), axis=-1),
                jnp.max(jnp.abs(yx / D), axis=-1),
            ),
        )
        eps_p = settings.eps_abs + settings.eps_rel * scale_p
        eps_d = settings.eps_abs + settings.eps_rel * scale_d
        conv = (r_prim <= eps_p) & (r_dual <= eps_d)
        ratio = jnp.sqrt(
            (r_prim / jnp.maximum(scale_p, 1e-12))
            / jnp.maximum(r_dual / jnp.maximum(scale_d, 1e-12), 1e-12)
        )
        return r_prim, r_dual, conv, ratio

    def step(state):
        x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv, k = state

        rc = rho_s[:, None] * pat_c
        rx = rho_s[:, None] * pat_x
        rhs = (
            sigma * x
            - qs
            + jnp.einsum("bmn,bm->bn", As, rc * zc - yc)
            + (rx * zx - yx)
        )
        xt = jnp.einsum("bij,bj->bi", M_inv, rhs)
        for _ in range(settings.kkt_refine):
            Mxt = _pmul(Ps, xt) + (sigma + rx) * xt + jnp.einsum(
                "bmn,bm->bn", As, rc * jnp.einsum("bmn,bn->bm", As, xt)
            )
            xt = xt + jnp.einsum("bij,bj->bi", M_inv, rhs - Mxt)
        zt_c = jnp.einsum("bmn,bn->bm", As, xt)

        x_new = alpha * xt + (1.0 - alpha) * x
        zc_arg = alpha * zt_c + (1.0 - alpha) * zc
        # numerator capped BEFORE the divide so the hard-row quotient can
        # never overflow f32 to inf
        zc_new = _soft_prox(
            zc_arg + yc / rc, lcs, ucs, jnp.minimum(soft_s, _HARD * rc) / rc
        )
        yc_new = yc + rc * (zc_arg - zc_new)
        zx_arg = alpha * xt + (1.0 - alpha) * zx
        zx_new = _soft_prox(
            zx_arg + yx / rx, lxs, uxs, jnp.minimum(soft_xs, _HARD * rx) / rx
        )
        yx_new = yx + rx * (zx_arg - zx_new)

        # freeze converged problems at their termination point
        keep = done[:, None]
        x = jnp.where(keep, x, x_new)
        zc = jnp.where(keep, zc, zc_new)
        zx = jnp.where(keep, zx, zx_new)
        yc = jnp.where(keep, yc, yc_new)
        yx = jnp.where(keep, yx, yx_new)

        k = k + 1

        def check(args):
            x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv = args
            rp_new, rd_new, conv, ratio = residuals(x, zc, zx, yc, yx)
            rp = jnp.where(done, rp, rp_new)
            rd = jnp.where(done, rd, rd_new)
            newly = conv & ~done
            iters = jnp.where(newly, k, iters)
            done = done | conv

            if settings.rho_update_every > 0:
                want = (
                    (k % settings.rho_update_every == 0)
                    & ~done
                    & ((ratio > 5.0) | (ratio < 0.2))
                )
                rho_new = jnp.where(
                    want,
                    jnp.clip(rho_s * ratio, settings.rho_min, settings.rho_max),
                    rho_s,
                )

                def refactor(_):
                    return factor(rho_new)

                M_inv = jax.lax.cond(
                    jnp.any(want), refactor, lambda _: M_inv, operand=None
                )
                rho_s = rho_new
            return x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv

        args = (x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv)
        x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv = jax.lax.cond(
            (k % settings.check_every == 0) | (k >= cap),
            check,
            lambda a: a,
            args,
        )
        return x, zc, zx, yc, yx, done, iters, rp, rd, rho_s, M_inv, k

    def cond(state):
        *_, done, _, _, _, _, _, k = state
        return (k < cap) & ~jnp.all(done)

    zeros_b = jnp.zeros(B, dt)
    state = (
        x,
        zc,
        zx,
        yc,
        yx,
        jnp.zeros(B, bool),
        jnp.full(B, cap, jnp.int32),
        zeros_b,
        zeros_b,
        rho0,
        M_inv0,
        jnp.asarray(0, jnp.int32),
    )
    x, zc, zx, yc, yx, done, iters, rp, rd, *_ = jax.lax.while_loop(cond, step, state)

    return QPSolution(
        x=D * x,
        y_constraints=E * yc,
        y_box=yx / D,
        converged=done,
        iterations=iters,
        prim_residual=rp,
        dual_residual=rd,
    )
