import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.ops.qp import QPSettings, solve_box_qp

INF = 1e20


def _kkt_check(P_diag, q, A, lc, uc, lx, ux, sol, tol=5e-3):
    """Verify OSQP-style KKT conditions of a returned solution."""
    x, yc, yx = np.asarray(sol.x), np.asarray(sol.y_constraints), np.asarray(sol.y_box)
    B = x.shape[0]
    for b in range(B):
        Ax = A[b] @ x[b]
        # primal feasibility
        assert np.all(Ax <= uc[b] + tol) and np.all(Ax >= lc[b] - tol)
        assert np.all(x[b] <= ux[b] + tol) and np.all(x[b] >= lx[b] - tol)
        # stationarity
        grad = P_diag[b] * x[b] + q[b] + A[b].T @ yc[b] + yx[b]
        np.testing.assert_allclose(grad, 0, atol=tol * 10)
        # dual signs: y >= 0 at upper, <= 0 at lower (within tol of the bound)
        for y, v, lo, hi in ((yc[b], Ax, lc[b], uc[b]), (yx[b], x[b], lx[b], ux[b])):
            active_up = v > hi - tol
            active_lo = v < lo + tol
            inactive = ~active_up & ~active_lo
            assert np.all(np.abs(y[inactive]) < tol * 50)


def test_unconstrained_quadratic():
    """No active constraints: solution is -q/P."""
    B, n = 3, 5
    rng = np.random.default_rng(0)
    P = jnp.asarray(rng.uniform(1.0, 3.0, (B, n)))
    q = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.zeros((B, 1, n))
    lc, uc = -INF * jnp.ones((B, 1)), INF * jnp.ones((B, 1))
    lx, ux = -INF * jnp.ones((B, n)), INF * jnp.ones((B, n))
    sol = solve_box_qp(P, q, A, lc, uc, lx, ux, QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000))
    assert bool(jnp.all(sol.converged))
    np.testing.assert_allclose(np.asarray(sol.x), -np.asarray(q) / np.asarray(P), atol=1e-4)


def test_box_projection():
    """Pure box: solution clips the unconstrained minimizer."""
    B, n = 2, 4
    rng = np.random.default_rng(1)
    P = jnp.ones((B, n))
    q = jnp.asarray(rng.normal(size=(B, n)) * 3)
    A = jnp.zeros((B, 1, n))
    lc, uc = -INF * jnp.ones((B, 1)), INF * jnp.ones((B, 1))
    lx = -0.5 * jnp.ones((B, n))
    ux = 0.5 * jnp.ones((B, n))
    sol = solve_box_qp(P, q, A, lc, uc, lx, ux, QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000))
    np.testing.assert_allclose(
        np.asarray(sol.x), np.clip(-np.asarray(q), -0.5, 0.5), atol=1e-4
    )


def test_equality_constrained_analytic():
    """min 1/2 x'Px + q'x  s.t.  A x = b  has closed-form KKT solution."""
    rng = np.random.default_rng(2)
    n, m = 6, 2
    P = rng.uniform(0.5, 2.0, n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    K = np.block([[np.diag(P), A.T], [A, np.zeros((m, m))]])
    sol_kkt = np.linalg.solve(K, np.concatenate([-q, b]))

    sol = solve_box_qp(
        jnp.asarray(P)[None],
        jnp.asarray(q)[None],
        jnp.asarray(A)[None],
        jnp.asarray(b)[None],
        jnp.asarray(b)[None],
        -INF * jnp.ones((1, n)),
        INF * jnp.ones((1, n)),
        QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=4000),
    )
    assert bool(sol.converged[0])
    np.testing.assert_allclose(np.asarray(sol.x[0]), sol_kkt[:n], atol=1e-4)
    # the equality dual matches the KKT multiplier
    np.testing.assert_allclose(np.asarray(sol.y_constraints[0]), sol_kkt[n:], atol=1e-3)


def test_random_inequality_qps_kkt():
    rng = np.random.default_rng(3)
    B, n, m = 8, 10, 6
    P = rng.uniform(0.2, 2.0, (B, n))
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    mid = rng.normal(size=(B, m))
    lc, uc = mid - 0.5, mid + 0.5
    lx, ux = -2.0 * np.ones((B, n)), 2.0 * np.ones((B, n))
    sol = solve_box_qp(
        *map(jnp.asarray, (P, q, A, lc, uc, lx, ux)),
        QPSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=4000),
    )
    assert bool(jnp.all(sol.converged))
    _kkt_check(P, q, A, lc, uc, lx, ux, sol, tol=1e-3)


def test_batch_elements_converge_independently():
    """An easy and a hard problem in one batch: both must converge and the
    recorded iteration counts must differ."""
    n = 8
    rng = np.random.default_rng(4)
    P = np.ones((2, n))
    q = np.stack([np.zeros(n), rng.normal(size=n) * 5])
    A = np.stack([np.eye(n)[:4], rng.normal(size=(4, n))])
    lc = np.stack([-np.ones(4), np.full(4, -0.1)])
    uc = np.stack([np.ones(4), np.full(4, 0.1)])
    lx, ux = -3 * np.ones((2, n)), 3 * np.ones((2, n))
    sol = solve_box_qp(
        *map(jnp.asarray, (P, q, A, lc, uc, lx, ux)),
        QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000, check_every=5),
    )
    assert bool(jnp.all(sol.converged))
    assert int(sol.iterations[0]) <= int(sol.iterations[1])


def test_infeasible_hits_iteration_cap():
    """Contradictory equality rows: solver must not converge, and must
    report the cap."""
    n = 4
    P = jnp.ones((1, n))
    q = jnp.zeros((1, n))
    A = jnp.asarray(np.stack([np.ones(n), np.ones(n)])[None])  # two identical rows
    lc = jnp.asarray([[0.0, 1.0]])  # x.sum()=0 and x.sum()=1 simultaneously
    uc = jnp.asarray([[0.0, 1.0]])
    lx, ux = -INF * jnp.ones((1, n)), INF * jnp.ones((1, n))
    sol = solve_box_qp(P, q, A, lc, uc, lx, ux, QPSettings(max_iter=200))
    assert not bool(sol.converged[0])
    assert int(sol.iterations[0]) == 200


def test_soft_rows_match_explicit_slack_oracle():
    """The prox-form l1 elastic (soft_c) is EXACTLY the slack-variable
    elastic: min 1/2 x^T P x + q^T x + w * dist(A x, [lc, uc]) equals the
    augmented QP with s+, s- >= 0, row A x - s+ + s- in [lc, uc] and linear
    cost w (s+ + s-). Both solved by the same ADMM; x must agree."""
    B, n, m = 3, 5, 3
    rng = np.random.default_rng(42)
    P = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    q = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.asarray(rng.normal(size=(B, m, n)))
    # tight, partly contradictory boxes so soft rows are actually violated
    lc = jnp.asarray(rng.uniform(-0.2, 0.0, (B, m)))
    uc = lc + jnp.asarray(rng.uniform(0.0, 0.1, (B, m)))
    lx, ux = -INF * jnp.ones((B, n)), INF * jnp.ones((B, n))
    w = 0.7
    soft_c = jnp.full((B, m), w)  # every constraint row soft

    st = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=8000)
    got = solve_box_qp(P, q, A, lc, uc, lx, ux, st, soft_c=soft_c)
    assert bool(jnp.all(got.converged))
    # soft-row duals are bounded by the weight
    assert float(jnp.max(jnp.abs(got.y_constraints))) <= w + 1e-4

    # oracle: explicit slack variables
    na = n + 2 * m
    P_a = jnp.concatenate([P, jnp.zeros((B, 2 * m))], axis=-1)
    q_a = jnp.concatenate([q, jnp.full((B, 2 * m), w)], axis=-1)
    eye = jnp.broadcast_to(jnp.eye(m), (B, m, m))
    A_a = jnp.concatenate([A, -eye, eye], axis=-1)
    lx_a = jnp.concatenate([lx, jnp.zeros((B, 2 * m))], axis=-1)
    ux_a = jnp.concatenate([ux, INF * jnp.ones((B, 2 * m))], axis=-1)
    ref = solve_box_qp(P_a, q_a, A_a, lc, uc, lx_a, ux_a, st)
    assert bool(jnp.all(ref.converged))
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x)[:, :n], atol=2e-4
    )
    # the paid violation matches the oracle's slack magnitudes
    Ax = np.einsum("bmn,bn->bm", np.asarray(A), np.asarray(got.x))
    viol = np.maximum(Ax - np.asarray(uc), 0) + np.maximum(np.asarray(lc) - Ax, 0)
    s = np.asarray(ref.x)[:, n:]
    np.testing.assert_allclose(viol, s[:, :m] + s[:, m:], atol=2e-4)


def test_soft_rows_inactive_when_feasible():
    """On a feasible QP whose optimal duals are below the weight, soft and
    hard solves return the same solution (exact penalty property)."""
    B, n, m = 2, 4, 2
    rng = np.random.default_rng(7)
    P = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    q = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.asarray(rng.normal(size=(B, m, n)))
    lc = -0.5 * jnp.ones((B, m))
    uc = 0.5 * jnp.ones((B, m))
    lx, ux = -2.0 * jnp.ones((B, n)), 2.0 * jnp.ones((B, n))
    st = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=8000)
    hard = solve_box_qp(P, q, A, lc, uc, lx, ux, st)
    soft = solve_box_qp(
        P, q, A, lc, uc, lx, ux, st, soft_c=jnp.full((B, m), 50.0)
    )
    assert bool(jnp.all(hard.converged)) and bool(jnp.all(soft.converged))
    np.testing.assert_allclose(
        np.asarray(soft.x), np.asarray(hard.x), atol=1e-4
    )


def test_soft_box_matches_explicit_slack_oracle():
    """The variable-box l1 elastic (soft_x) is EXACTLY the slack-variable
    elastic on the bound rows: min .. + w * dist(x, [lx, ux]) equals the
    augmented QP with s+, s- >= 0, identity rows x - s+ + s- in [lx, ux]
    (moved into the A-rows) and linear cost w (s+ + s-)."""
    B, n, m = 3, 5, 2
    rng = np.random.default_rng(11)
    P = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    q = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.asarray(rng.normal(size=(B, m, n)))
    # equality rows that CONTRADICT the tight variable box -> the box must
    # be violated at the optimum (the planner's primal-infeasible case)
    lc = jnp.asarray(rng.uniform(1.5, 2.5, (B, m)))
    uc = lc
    lx = -0.1 * jnp.ones((B, n))
    ux = 0.1 * jnp.ones((B, n))
    w = 0.7
    soft_x = jnp.full((B, n), w)

    st = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=8000)
    got = solve_box_qp(P, q, A, lc, uc, lx, ux, st, soft_x=soft_x)
    assert bool(jnp.all(got.converged))
    # soft-box duals are bounded by the weight
    assert float(jnp.max(jnp.abs(got.y_box))) <= w + 1e-4

    # oracle: identity rows moved to A with explicit slack variables
    na = n + 2 * n
    eyeN = jnp.broadcast_to(jnp.eye(n), (B, n, n))
    P_a = jnp.concatenate([P, jnp.zeros((B, 2 * n))], axis=-1)
    q_a = jnp.concatenate([q, jnp.full((B, 2 * n), w)], axis=-1)
    A_a = jnp.concatenate(
        [
            jnp.concatenate([A, jnp.zeros((B, m, 2 * n))], axis=-1),
            jnp.concatenate([eyeN, -eyeN, eyeN], axis=-1),
        ],
        axis=1,
    )
    lc_a = jnp.concatenate([lc, lx], axis=-1)
    uc_a = jnp.concatenate([uc, ux], axis=-1)
    lx_a = jnp.concatenate(
        [-INF * jnp.ones((B, n)), jnp.zeros((B, 2 * n))], axis=-1
    )
    ux_a = INF * jnp.ones((B, na))
    ref = solve_box_qp(P_a, q_a, A_a, lc_a, uc_a, lx_a, ux_a, st)
    assert bool(jnp.all(ref.converged))
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x)[:, :n], atol=2e-4
    )
    # the paid box violation matches the oracle's slack magnitudes
    x = np.asarray(got.x)
    viol = np.maximum(x - np.asarray(ux), 0) + np.maximum(np.asarray(lx) - x, 0)
    s = np.asarray(ref.x)[:, n:]
    np.testing.assert_allclose(viol, s[:, :n] + s[:, n:], atol=2e-4)


def test_soft_box_inactive_when_feasible():
    """Exact penalty: on a feasible QP with optimal box duals below the
    weight, soft-box and hard solves agree."""
    B, n, m = 2, 4, 2
    rng = np.random.default_rng(7)
    P = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    q = jnp.asarray(rng.normal(size=(B, n)))
    A = jnp.asarray(rng.normal(size=(B, m, n)))
    lc = -0.5 * jnp.ones((B, m))
    uc = 0.5 * jnp.ones((B, m))
    lx, ux = -2.0 * jnp.ones((B, n)), 2.0 * jnp.ones((B, n))
    st = QPSettings(eps_abs=1e-7, eps_rel=1e-7, max_iter=8000)
    hard = solve_box_qp(P, q, A, lc, uc, lx, ux, st)
    soft = solve_box_qp(
        P, q, A, lc, uc, lx, ux, st, soft_x=jnp.full((B, n), 50.0)
    )
    assert bool(jnp.all(hard.converged)) and bool(jnp.all(soft.converged))
    np.testing.assert_allclose(
        np.asarray(soft.x), np.asarray(hard.x), atol=1e-4
    )


def test_kkt_refine_matches_plain():
    """kkt_refine=1 (iterative refinement on the x-update solve) must reach
    the same solution — it only sharpens the linear solve."""
    rng = np.random.default_rng(11)
    B, n, m = 4, 16, 12
    P = rng.uniform(0.1, 1.0, (B, n))
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    lc = rng.uniform(-2, -0.5, (B, m))
    uc = rng.uniform(0.5, 2, (B, m))
    lc[:, :3] = uc[:, :3] = 0.1
    lx, ux = np.full((B, n), -3.0), np.full((B, n), 3.0)
    args = tuple(map(jnp.asarray, (P, q, A, lc, uc, lx, ux)))

    ref = solve_box_qp(*args, QPSettings(max_iter=2000))
    sol = solve_box_qp(*args, QPSettings(max_iter=2000, kkt_refine=1))
    assert bool(jnp.all(sol.converged))
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x), atol=5e-3)


def test_cholesky_factor_matches_lu():
    """kkt_factor="cholesky" must reproduce the LU-inverse path (M is SPD
    by construction)."""
    rng = np.random.default_rng(7)
    B, n, m = 4, 16, 12
    P = rng.uniform(0.1, 1.0, (B, n))
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    lc = rng.uniform(-2, -0.5, (B, m))
    uc = rng.uniform(0.5, 2, (B, m))
    lc[:, :3] = uc[:, :3] = 0.1
    lx, ux = np.full((B, n), -3.0), np.full((B, n), 3.0)
    args = tuple(map(jnp.asarray, (P, q, A, lc, uc, lx, ux)))

    ref = solve_box_qp(*args, QPSettings(max_iter=2000))
    sol = solve_box_qp(*args, QPSettings(max_iter=2000, kkt_factor="cholesky"))
    assert bool(jnp.all(sol.converged))
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x), atol=5e-3)


@pytest.mark.parametrize(
    "spec, caps", [("700", [700]), ("700;500", [700, 500]), (" 300 ; 50 ", [300, 50])]
)
def test_parse_step_budgets(spec, caps):
    from mpc_motion_planner_tpu.ops.sqp import parse_step_budgets

    assert parse_step_budgets(spec) == caps


@pytest.mark.parametrize("spec", ["300,400;200", "700;", "0", "-5", "abc"])
def test_parse_step_budgets_rejects(spec):
    from mpc_motion_planner_tpu.ops.sqp import parse_step_budgets

    with pytest.raises(ValueError, match="qp_step_schedules"):
        parse_step_budgets(spec)


def test_dense_P_matches_diagonal_path():
    """A dense P that happens to be diagonal must reproduce the vector-P
    solution exactly (same algorithm, same scaling)."""
    rng = np.random.default_rng(21)
    B, n, m = 3, 8, 5
    P = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    q = jnp.asarray(rng.standard_normal((B, n)))
    A = jnp.asarray(rng.standard_normal((B, m, n)))
    lc = jnp.asarray(rng.uniform(-2.0, -0.5, (B, m)))
    uc = jnp.asarray(rng.uniform(0.5, 2.0, (B, m)))
    lx = jnp.full((B, n), -3.0)
    ux = jnp.full((B, n), 3.0)
    settings = QPSettings(max_iter=2000)
    ref = solve_box_qp(P, q, A, lc, uc, lx, ux, settings)
    P_dense = jnp.stack([jnp.diag(P[b]) for b in range(B)])
    got = solve_box_qp(P_dense, q, A, lc, uc, lx, ux, settings)
    assert bool(jnp.all(got.converged))
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(got.iterations), np.asarray(ref.iterations)
    )


def test_dense_P_general_hessian_kkt():
    """General (non-diagonal) PSD Hessian: verify the KKT conditions of the
    returned solution directly (stationarity + primal feasibility +
    complementarity), matching boxADMM's general-QP capability."""
    rng = np.random.default_rng(22)
    B, n, m = 4, 10, 6
    G = rng.standard_normal((B, n, n))
    P = jnp.asarray(np.einsum("bki,bkj->bij", G, G) / n + 0.1 * np.eye(n))
    q = jnp.asarray(rng.standard_normal((B, n)))
    A = jnp.asarray(rng.standard_normal((B, m, n)))
    lc = jnp.asarray(rng.uniform(-2.0, -0.5, (B, m)))
    uc = jnp.asarray(rng.uniform(0.5, 2.0, (B, m)))
    lx = jnp.full((B, n), -5.0)
    ux = jnp.full((B, n), 5.0)
    sol = solve_box_qp(P, q, A, lc, uc, lx, ux, QPSettings(max_iter=4000))
    assert bool(jnp.all(sol.converged))
    x, y, yx = np.asarray(sol.x), np.asarray(sol.y_constraints), np.asarray(sol.y_box)
    # stationarity: P x + q + A^T y + y_box = 0
    stat = np.einsum("bij,bj->bi", np.asarray(P), x) + np.asarray(q)
    stat += np.einsum("bmn,bm->bn", np.asarray(A), y) + yx
    assert np.abs(stat).max() < 5e-3
    # primal feasibility
    Ax = np.einsum("bmn,bn->bm", np.asarray(A), x)
    assert (Ax - np.asarray(uc)).max() < 5e-3
    assert (np.asarray(lc) - Ax).max() < 5e-3


def test_dense_P_rejected_off_xla():
    P = jnp.eye(4)[None].repeat(2, 0)
    q = jnp.zeros((2, 4))
    A = jnp.ones((2, 1, 4))
    with pytest.raises(ValueError, match="dense P"):
        solve_box_qp(
            P, q, A, -jnp.ones((2, 1)), jnp.ones((2, 1)),
            -jnp.ones((2, 4)), jnp.ones((2, 4)),
            QPSettings(backend="structured"),
        )


def test_gershgorin_regularization_general_hessian():
    """The general Gershgorin shift (polympc_redef.hpp:41-62) renders a
    random indefinite symmetric H positive definite and leaves strictly
    diagonally dominant PD matrices untouched."""
    from mpc_motion_planner_tpu.ops.sqp import gershgorin_regularize

    rng = np.random.default_rng(23)
    H = rng.standard_normal((5, 16, 16))
    H = jnp.asarray(H + np.swapaxes(H, -1, -2))
    assert np.linalg.eigvalsh(np.asarray(H)).min() < 0  # indefinite input
    Hr = gershgorin_regularize(H, eps=0.01)
    eigs = np.linalg.eigvalsh(np.asarray(Hr))
    assert eigs.min() > 0
    # off-diagonals untouched
    off = np.array(Hr - H)
    off[:, np.arange(16), np.arange(16)] = 0.0
    assert np.abs(off).max() == 0.0

    # strictly diagonally dominant: aii - ri > 0 everywhere -> unchanged
    Hd = np.asarray(H) + np.eye(16) * (
        np.abs(np.asarray(H)).sum(-1).max() + 1.0
    )
    np.testing.assert_array_equal(
        np.asarray(gershgorin_regularize(jnp.asarray(Hd))), Hd
    )


def test_sqp_accepts_problem_delegated_hessian():
    """sqp_solve's hessian_fn hook (polympc_redef.hpp:124-128): a nonzero
    Lagrangian Hessian flows through Gershgorin regularization and the
    dense-P QP; with H == 0 it must reproduce the default path."""
    import jax

    from mpc_motion_planner_tpu.ops.sqp import SQPSettings, sqp_solve
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1))
    key = jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    cur = jnp.concatenate(planner.sample_random_state(k1, (2,)), -1)
    tgt = jnp.concatenate(planner.sample_random_state(k2, (2,)), -1)
    bounds = planner.nlp_bounds(cur, tgt)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))
    ocp = planner.ocp
    n = ocp.num_var

    ref = sqp_solve(ocp, bounds, z0, SQPSettings(max_iter=1), QPSettings())
    zero_h = lambda z, lam: jnp.zeros((z.shape[0], n, n), z.dtype)
    got = sqp_solve(
        ocp, bounds, z0, SQPSettings(max_iter=1), QPSettings(),
        hessian_fn=zero_h,
    )
    np.testing.assert_allclose(
        np.asarray(got.z), np.asarray(ref.z), rtol=1e-6, atol=1e-8
    )
