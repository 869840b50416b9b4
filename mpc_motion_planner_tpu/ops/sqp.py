"""Batched SQP solver for the transcribed minimum-time NLP.

Reproduces the semantics of polyMPC's ``SQPBase`` with the reference's
``MySolver`` customizations (/root/reference/mpc_solver/polympc_redef.hpp):

* Full relinearization every SQP iteration ("fix from Roland",
  polympc_redef.hpp:133-147) — cost gradient, constraint values and exact
  constraint Jacobians are recomputed at the current iterate.
* Hessian regularization by Gershgorin-disc shift (polympc_redef.hpp:41-70).
  The reference's Lagrangian Hessian is identically zero (its second-order
  constraint derivatives return zeros, robot_ocp.hpp:165-168, and the cost
  is linear), so the shift yields the constant diagonal 0.01 — kept here as
  an explicit function of the (zero) Hessian for fidelity.
* l1-merit backtracking line search (polympc_redef.hpp:73-121):
  phi(x) = cost(x) + mu * ||violation(x)||_1 with mu = ||lambda_qp||_inf,
  Armijo acceptance with slope eta, decrease factor tau; trial steps
  tau^0 .. tau^(L-2), falling back to tau^(L-1) — vectorized so all L
  candidates evaluate in one batched sweep instead of a sequential loop.
* Dual update lam <- lam + alpha (lam_qp - lam), fixed `max_iter`
  outer iterations (2 in the planner, motionPlanner.cpp:15).

Everything carries a leading batch axis; per-problem OCP callbacks are
vmapped internally.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..ocp import NLPBounds, TranscribedOCP
from .qp import QPSettings, QPSolution, solve_box_qp
from .qp_structured import solve_box_qp_structured
from .structure import build_structured_A


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SQPSettings:
    max_iter: int = dataclasses.field(default=2, metadata={"static": True})
    line_search_max_iter: int = dataclasses.field(default=10, metadata={"static": True})
    tau: float = dataclasses.field(default=0.5, metadata={"static": True})
    eta: float = dataclasses.field(default=0.25, metadata={"static": True})
    # Gershgorin shift applied to the (zero) Lagrangian Hessian diagonal
    reg_eps: float = dataclasses.field(default=0.01, metadata={"static": True})
    # l1 elastic relaxation of the nonlinear inequality rows (all ng rows
    # per node: torque + height): each row may be violated in the QP at
    # linear cost `slack_penalty` per unit, implemented slack-free as a
    # prox in the ADMM z-update (qp._soft_prox). Warm-start paths that dip
    # the tool below the table otherwise make the linearized QP
    # primal-infeasible (pinned boundary states + defect rows conflict
    # with the height rows), the ADMM duals diverge and the SQP step is
    # useless — a failure mode the reference shares. An exact l1 penalty
    # (mu larger than the rows' optimal duals — measured row duals on the
    # chained workload stay well under 1) leaves feasible solves
    # unchanged while bounding every soft row's dual by mu. 0 disables
    # (reference behavior). Round 1 implemented this with explicit slack
    # VARIABLES on the height rows only; the prox form extends it to the
    # torque rows with zero extra state and no effect on the Ruiz scaling
    # (the old slack columns entered A and degraded it: mu=100 doubled
    # median violation; the prox threshold never touches A).
    slack_penalty: float = dataclasses.field(default=10.0, metadata={"static": True})
    # l1 elastic relaxation of the VARIABLE box on the controls and the
    # interior states (SNOPT-style elastic mode, qp._soft_prox on the
    # zx-update). Why: the unconverged ~18% of chained-workload QPs are
    # structurally primal-infeasible — correcting the warm start's defect
    # residual within the pinned endpoints demands more control authority
    # than the margin-scaled acceleration box allows, so the U-box primal
    # residual plateaus and NO iteration budget / rho schedule converges
    # (measured, experiments/conv_diag.py; doubling the budget to 1400
    # iterations changes nothing). Softening those rows makes every
    # linearized QP feasible; the exact-penalty property leaves feasible
    # solves unchanged (weight > the rows' optimal box duals). The pinned
    # node-0 state, the terminal +-1e-2 box and the t_f parameter stay
    # HARD — target accuracy semantics are untouched, and the returned
    # iterate is still clipped to the full box after the last SQP step.
    # Weight 3.0 measured best on the B=256 chained workload
    # (experiments/conv_diag.py): conv 0.77/0.82 -> 0.90/1.00 per SQP
    # step AND better solution quality (l1 violation p90 6.9 -> 5.5, max
    # 25.1 -> 20.4 — a stalled ADMM returns a poorer step than a
    # converged relaxed one); 10.0 matches step0 but loses step1 (0.98),
    # 30.0 degrades both (0.88/0.94, max viol 30). 0 disables (reference
    # behavior). CAVEAT (exact-penalty assumption): feasible solves are
    # only guaranteed unchanged while the weight exceeds the optimal box
    # duals of the softened rows; this is an empirical property of the
    # workload, not enforced. It is checkable from SQPResult.lam_x — if
    # max |lam_x| over the soft control/interior-state rows approaches the
    # weight, the penalty is binding on feasible problems and should be
    # raised (the acceptance harness reports this saturation statistic,
    # RESULTS.md).
    box_slack_penalty: float = dataclasses.field(
        default=3.0, metadata={"static": True}
    )
    # Per-SQP-step ADMM budgets: semicolon-separated iteration caps, one
    # per SQP iteration (e.g. "700;500"). SQP step i solves its QP with
    # QPSettings.max_iter replaced by entry min(i, last); empty keeps the
    # single shared QPSettings (reference behavior — polyMPC uses one
    # solver instance for every SQP iteration). The step-1 QP is
    # dual-warm-started from step 0 on a nearly unchanged linearization and
    # converges in fewer iterations (iteration p50 125 vs 175, p99 500 vs
    # 638 on the chained workload, KERNELS.md), so a smaller step-1 cap
    # can leave its result unchanged.
    qp_step_schedules: str = dataclasses.field(
        default="", metadata={"static": True}
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SQPResult:
    z: jax.Array  # (B, num_var) final iterate
    lam_c: jax.Array  # (B, num_eq + num_ineq) constraint duals
    lam_x: jax.Array  # (B, num_var) variable-box duals
    cost: jax.Array  # (B,)
    violation: jax.Array  # (B,) l1 constraint violation at the solution
    qp_iterations: jax.Array  # (B, sqp_iters)
    qp_converged: jax.Array  # (B, sqp_iters) bool
    step_sizes: jax.Array  # (B, sqp_iters)


def parse_step_budgets(spec: str):
    """"700;500" -> [700, 500]: the per-SQP-step ADMM caps of
    SQPSettings.qp_step_schedules. Raises on anything but positive
    integers."""
    caps = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry.isdigit() or int(entry) <= 0:
            raise ValueError(
                f"qp_step_schedules must be ';'-separated positive integers, "
                f"got {spec!r}"
            )
        caps.append(int(entry))
    return caps


def hessian_regularization_diag(ocp: TranscribedOCP, batch_shape, dtype, eps):
    """Gershgorin shift specialized to the planner's H == 0 (the reference's
    second-order constraint derivatives return zeros, robot_ocp.hpp:165-168,
    and the cost is linear): the general rule below yields the constant eps
    diagonal."""
    return jnp.full((*batch_shape, ocp.num_var), eps, dtype)


def gershgorin_regularize(H, eps=0.01):
    """General Gershgorin-disc regularization of a batched symmetric
    Lagrangian Hessian (B, n, n) — the actual algorithm of the reference's
    ``hessian_regularisation_dense_impl``
    (/root/reference/mpc_solver/polympc_redef.hpp:41-62): for every row i
    with a_ii - r_i <= 0 (r_i = sum_j |H_ij| - |a_ii|), shift the diagonal
    by (r_i - a_ii) + eps so all Gershgorin discs lie in the positive
    half-plane (H becomes positive definite)."""
    aii = jnp.diagonal(H, axis1=-2, axis2=-1)
    ri = jnp.sum(jnp.abs(H), axis=-1) - jnp.abs(aii)
    shift = jnp.where(aii - ri <= 0, (ri - aii) + eps, 0.0)
    n = H.shape[-1]
    eye = jnp.eye(n, dtype=H.dtype)
    return H + shift[..., None] * eye


def constraint_violation(ocp: TranscribedOCP, bounds: NLPBounds, z):
    """l1 norm of all constraint violations at z (equality defects,
    inequality box, variable box) — polyMPC's constraints_violation."""
    c_eq = jax.vmap(ocp.eq_residual)(z)
    g = ocp.ineq_residual_batch(z)
    v_eq = jnp.sum(jnp.abs(c_eq), axis=-1)
    v_g = jnp.sum(
        jnp.maximum(g - bounds.ub_ineq, 0.0) + jnp.maximum(bounds.lb_ineq - g, 0.0),
        axis=-1,
    )
    v_x = jnp.sum(
        jnp.maximum(z - bounds.ub_var, 0.0) + jnp.maximum(bounds.lb_var - z, 0.0),
        axis=-1,
    )
    return v_eq + v_g + v_x


def _line_search(ocp, bounds, z, d, h, mu, settings: SQPSettings,
                 c_eq=None, g=None):
    """Vectorized l1-merit backtracking; returns per-problem alpha (B,).

    Device-cost design: the defect residual is
    BILINEAR in (p, [X; U]), so every candidate's equality violation comes
    from the exact quadratic expansion ocp.eq_residual_quadratic — three
    (B, num_eq) tensors combined elementwise — instead of re-running the
    full defect chain at L x B. Only the genuinely nonlinear per-node
    constraint rows evaluate for real, as one batched evaluation over the
    (L*B)-flat candidate batch. The violation at z itself reuses the SQP
    iteration's linearization residuals (c_eq, g) when given. Semantics are
    identical to evaluating constraint_violation at every candidate
    (parity-tested, tests/test_ocp.py::test_eq_residual_quadratic).
    """
    L = settings.line_search_max_iter
    tau = settings.tau
    B, n = z.shape
    alphas = jnp.asarray([tau**j for j in range(L)], z.dtype)  # (L,)

    lb_x = jnp.broadcast_to(bounds.lb_var, (B, n))
    ub_x = jnp.broadcast_to(bounds.ub_var, (B, n))
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))

    # ---- merit at z (reusing the linearization's residuals) ----
    if c_eq is None:
        c_eq = jax.vmap(ocp.eq_residual)(z)
    if g is None:
        g = ocp.ineq_residual_batch(z)
    viol0 = (
        jnp.sum(jnp.abs(c_eq), axis=-1)
        + jnp.sum(jnp.maximum(g - ub_g, 0.0) + jnp.maximum(lb_g - g, 0.0),
                  axis=-1)
        + jnp.sum(jnp.maximum(z - ub_x, 0.0) + jnp.maximum(lb_x - z, 0.0),
                  axis=-1)
    )
    phi0 = ocp.cost(z) + mu * viol0
    dphi = jnp.sum(h * d, axis=-1) - mu * viol0  # directional merit derivative

    # ---- equality defects of ALL candidates: exact quadratic expansion ----
    c0, c1, c2 = jax.vmap(ocp.eq_residual_quadratic)(z, d)
    a1 = alphas[:, None, None]
    v_eq = jnp.sum(jnp.abs(c0[None] + a1 * c1[None] + (a1 * a1) * c2[None]),
                   axis=-1)  # (L, B)

    # ---- nonlinear rows + variable box at the candidates ----
    z_try = (z[None] + alphas[:, None, None] * d[None]).reshape(L * B, n)
    g_try = ocp.ineq_residual_batch(z_try).reshape(L, B, -1)
    v_g = jnp.sum(
        jnp.maximum(g_try - ub_g[None], 0.0)
        + jnp.maximum(lb_g[None] - g_try, 0.0),
        axis=-1,
    )
    z_lbx = z_try.reshape(L, B, n)
    v_x = jnp.sum(
        jnp.maximum(z_lbx - ub_x[None], 0.0)
        + jnp.maximum(lb_x[None] - z_lbx, 0.0),
        axis=-1,
    )
    viols = v_eq + v_g + v_x
    phis = ocp.cost(z_try).reshape(L, B) + mu[None, :] * viols  # (L, B)
    accept = phis <= phi0[None, :] + alphas[:, None] * settings.eta * dphi[None, :]
    # Trials are tau^0 .. tau^(L-2); tau^(L-1) is the untested fallback
    # (mirrors the loop bounds at polympc_redef.hpp:101-120).
    accept = accept.at[L - 1, :].set(True)
    first = jnp.argmax(accept, axis=0)  # (B,) first accepted index
    return alphas[first]


def sqp_solve(
    ocp: TranscribedOCP,
    bounds: NLPBounds,
    z0,
    settings: SQPSettings = SQPSettings(),
    qp_settings: QPSettings = QPSettings(),
    lam_c0=None,
    lam_x0=None,
    hessian_fn=None,
) -> SQPResult:
    """Run `settings.max_iter` SQP iterations from the warm start z0.

    z0: (B, num_var); bounds leaves are (num_var,)/(num_ineq,) or batched.

    hessian_fn: optional problem-delegated Lagrangian-Hessian callback
    ``(z (B, n), lam_c (B, m)) -> (B, n, n)`` — the counterpart of
    polyMPC's ``hessian_update_impl`` hook (polympc_redef.hpp:124-128).
    When given, the dense Hessian is Gershgorin-regularized
    (:func:`gershgorin_regularize`) and passed to the QP; requires the
    'xla' QP backend (dense P). When None (the planner's case, H == 0),
    the regularization reduces to the constant eps diagonal.
    """
    # Full-precision matmuls throughout (a float32 matmul at default
    # precision may run in TF32 on the GPU, which is not accurate enough for
    # the Jacobian assembly / dynamics sweeps).
    with jax.default_matmul_precision("highest"):
        return _sqp_solve_impl(
            ocp, bounds, z0, settings, qp_settings, lam_c0, lam_x0, hessian_fn
        )


def _sqp_solve_impl(
    ocp, bounds, z0, settings, qp_settings, lam_c0, lam_x0, hessian_fn=None
) -> SQPResult:
    B = z0.shape[0]
    dt = z0.dtype
    n = ocp.num_var
    m = ocp.num_eq + ocp.num_ineq

    lam_c = jnp.zeros((B, m), dt) if lam_c0 is None else lam_c0
    lam_x = jnp.zeros((B, ocp.num_var), dt) if lam_x0 is None else lam_x0

    lb_var = jnp.broadcast_to(bounds.lb_var, z0.shape)
    ub_var = jnp.broadcast_to(bounds.ub_var, z0.shape)
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))

    # ---- l1 elastic (soft) nonlinear inequality rows (see SQPSettings):
    # equality/defect rows stay hard, every per-node constraint row gets
    # the slack-free prox relaxation with weight slack_penalty. Both weight
    # arrays are one row that broadcasts over the batch: a (B, m) constant
    # would be constant-folded by the compiler at every batch size.
    if settings.slack_penalty > 0:
        soft_c = jnp.zeros((1, m), dt).at[:, ocp.num_eq :].set(
            settings.slack_penalty
        )
    else:
        soft_c = None

    # ---- l1 elastic variable box (see SQPSettings.box_slack_penalty):
    # soft on the interior X nodes (1 .. nodes-2) and ALL U rows; hard on
    # the pinned node-0 state, the terminal-box node and the parameter p.
    if settings.box_slack_penalty > 0:
        nodes, nx_, nu_ = ocp.num_nodes, ocp.nx, ocp.nu
        wx = jnp.zeros((ocp.num_var,), dt)
        wx = wx.at[nx_ : (nodes - 1) * nx_].set(settings.box_slack_penalty)
        wx = wx.at[nodes * nx_ : nodes * (nx_ + nu_)].set(
            settings.box_slack_penalty
        )
        soft_x = wx[None, :]
    else:
        soft_x = None

    # Per-step QP budgets (SQPSettings.qp_step_schedules): step i's ADMM
    # loop runs to its own cap, passed to the QP solver as a traced value,
    # so every SQP step is one iteration of a lax.scan over the caps and
    # the solve is traced (and compiled) once, not once per step.
    if settings.qp_step_schedules:
        caps = parse_step_budgets(settings.qp_step_schedules)
    else:
        caps = [qp_settings.max_iter]
    step_caps = jnp.asarray(
        [caps[min(i, len(caps) - 1)] for i in range(settings.max_iter)],
        jnp.int32,
    )

    structured = qp_settings.backend == "structured"

    def sqp_step(carry, cap):
        z, lam_c, lam_x = carry
        # ---- full relinearization at the current iterate ----
        c_eq = jax.vmap(ocp.eq_residual)(z)  # (B, num_eq)
        if structured:
            # matrix-free: A is never materialized (ops/structure.py);
            # g and the per-node Jacobians come from one batched evaluation
            g, J = ocp.linearize_constraints_batch(z)
            sa = build_structured_A(ocp, z, J=J)
        else:
            g = jax.vmap(ocp.ineq_residual)(z)  # (B, num_ineq)
            A = jax.vmap(ocp.constraint_matrix)(z)  # (B, m, n)
        h = jax.vmap(ocp.cost_gradient)(z)  # (B, n)
        if hessian_fn is None:
            P_diag = hessian_regularization_diag(
                ocp, (B,), dt, settings.reg_eps
            )
        else:
            P_diag = gershgorin_regularize(
                hessian_fn(z, lam_c), settings.reg_eps
            )

        # ---- QP subproblem over the step d (soft nonlinear rows) ----
        lc = jnp.concatenate([-c_eq, lb_g - g], axis=-1)
        uc = jnp.concatenate([-c_eq, ub_g - g], axis=-1)
        lx = lb_var - z
        ux = ub_var - z
        if structured:
            qp: QPSolution = solve_box_qp_structured(
                ocp, sa, P_diag, h, lc, uc, lx, ux, qp_settings,
                yc0=lam_c, yx0=lam_x, soft_c=soft_c, soft_x=soft_x,
                max_iter=cap,
            )
        else:
            qp = solve_box_qp(
                P_diag, h, A, lc, uc, lx, ux, qp_settings,
                yc0=lam_c, yx0=lam_x, soft_c=soft_c, soft_x=soft_x,
                max_iter=cap,
            )
        d = qp.x
        y_box = qp.y_box

        # ---- merit line search ----
        mu = jnp.maximum(
            jnp.max(jnp.abs(qp.y_constraints), axis=-1),
            jnp.max(jnp.abs(y_box), axis=-1),
        )
        alpha = _line_search(ocp, bounds, z, d, h, mu, settings, c_eq=c_eq, g=g)

        # ---- primal/dual update ----
        z = z + alpha[:, None] * d
        lam_c = lam_c + alpha[:, None] * (qp.y_constraints - lam_c)
        lam_x = lam_x + alpha[:, None] * (y_box - lam_x)
        return (z, lam_c, lam_x), (qp.iterations, qp.converged, alpha)

    (z, lam_c, lam_x), (qp_iters, qp_conv, alphas) = jax.lax.scan(
        sqp_step, (z0, lam_c, lam_x), step_caps
    )

    # Project the final iterate onto the variable box: ADMM satisfies the
    # box only to its primal tolerance (~1e-3 * eps), while callers rely on
    # the pinned node-0 state (lb = ub) holding exactly for hot restarts.
    z = jnp.clip(z, lb_var, ub_var)

    return SQPResult(
        z=z,
        lam_c=lam_c,
        lam_x=lam_x,
        cost=ocp.cost(z),
        violation=constraint_violation(ocp, bounds, z),
        qp_iterations=jnp.moveaxis(qp_iters, 0, -1),
        qp_converged=jnp.moveaxis(qp_conv, 0, -1),
        step_sizes=jnp.moveaxis(alphas, 0, -1),
    )
