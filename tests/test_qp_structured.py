"""Structured (matrix-free) QP backend vs dense references.

Layered validation: structured Ruiz vs the dense sweep, banded M assembly
vs the materialized normal matrix, block-banded Cholesky + arrow solve vs
jnp.linalg.solve, and finally the full structured ADMM vs the dense XLA
backend on real planner subproblems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.models.panda import make_panda_model
from mpc_motion_planner_tpu.ocp import make_ocp
from mpc_motion_planner_tpu.ops import qp_structured as qs
from mpc_motion_planner_tpu.ops import structure
from mpc_motion_planner_tpu.ops.qp import QPSettings, _rho_pattern, _ruiz_equilibrate


@pytest.fixture(scope="module")
def ocp():
    return make_ocp(make_panda_model())


def _random_z(ocp, key, B):
    kq, kv, ku, kp = jax.random.split(key, 4)
    n, nq = ocp.num_nodes, ocp.nq
    X = jnp.concatenate(
        [
            jax.random.uniform(kq, (B, n, nq), minval=-2.0, maxval=2.0),
            jax.random.uniform(kv, (B, n, nq), minval=-2.0, maxval=2.0),
        ],
        axis=-1,
    )
    U = jax.random.uniform(ku, (B, n, nq), minval=-5.0, maxval=5.0)
    p = jax.random.uniform(kp, (B,), minval=0.5, maxval=3.0)
    return jax.vmap(ocp.pack)(X, U, p)


def test_ruiz_structured_matches_dense(ocp):
    B = 2
    z = _random_z(ocp, jax.random.PRNGKey(0), B)
    sa = structure.build_structured_A(ocp, z)
    A = structure.materialize(ocp, sa)
    D_ref, E_ref = _ruiz_equilibrate(A, iters=6)
    D, E = qs.ruiz_structured(ocp, sa, iters=6)
    np.testing.assert_allclose(np.asarray(D), np.asarray(D_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(E), np.asarray(E_ref), rtol=1e-12)


def test_banded_assembly_matches_dense_normal_matrix(ocp):
    B = 2
    z = _random_z(ocp, jax.random.PRNGKey(1), B)
    sa = structure.build_structured_A(ocp, z)
    n = ocp.num_var
    m = ocp.num_eq + ocp.num_ineq
    rng = np.random.default_rng(5)
    D = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    E = jnp.asarray(rng.uniform(0.5, 2.0, (B, m)))
    w = jnp.asarray(rng.uniform(0.1, 3.0, (B, m)))  # row weights E^2 rho
    sig = jnp.asarray(rng.uniform(0.5, 1.5, (B, n)))

    # assemble_banded_M's contract: w are row weights (E^2 rho) on the
    # UNSCALED A, D the column scaling: M = D A^T diag(w) A D + diag(sig)
    A = np.asarray(structure.materialize(ocp, sa))
    Dn = np.asarray(D)
    M_ref = np.einsum("bmi,bm,bmj->bij", A, np.asarray(w), A)
    M_ref = Dn[:, :, None] * M_ref * Dn[:, None, :]
    M_ref += np.stack([np.diag(np.asarray(sig)[b]) for b in range(B)])

    K, nx = ocp.coll.order + 1, ocp.nx
    w_eq = w[:, : ocp.num_eq].reshape(B, -1, K, nx)
    w_g = w[:, ocp.num_eq :].reshape(B, ocp.num_nodes, -1)
    Mband, p_col, m_pp = qs.assemble_banded_M(ocp, sa, w_eq, w_g, D, sig)

    # compare banded blocks + arrow against the node-major permutation of M_ref
    nodes, nu = ocp.num_nodes, ocp.nu
    blk = nx + nu
    perm = []
    for k in range(nodes):
        perm.extend(range(k * nx, (k + 1) * nx))
        perm.extend(range(nodes * nx + k * nu, nodes * nx + (k + 1) * nu))
    p_idx = nodes * (nx + nu)
    Mp = M_ref[:, perm][:, :, perm]
    for k in range(nodes):
        for d in range(ocp.coll.order + 1):
            if k + d >= nodes:
                continue
            ref_blk = Mp[:, (k + d) * blk : (k + d + 1) * blk, k * blk : (k + 1) * blk]
            if d > 0:
                got = np.asarray(Mband[:, k, d])
            else:
                got = np.asarray(Mband[:, k, 0])
            np.testing.assert_allclose(got, ref_blk, atol=1e-9, err_msg=f"k={k} d={d}")
    # arrow
    pc_ref = M_ref[:, perm, :][:, :, p_idx].reshape(B, nodes, blk)
    np.testing.assert_allclose(np.asarray(p_col), pc_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(m_pp), M_ref[:, p_idx, p_idx], atol=1e-9)


def test_factor_solve_matches_dense_solve(ocp):
    B = 2
    z = _random_z(ocp, jax.random.PRNGKey(2), B)
    sa = structure.build_structured_A(ocp, z)
    n = ocp.num_var
    m = ocp.num_eq + ocp.num_ineq
    rng = np.random.default_rng(9)
    D = jnp.asarray(rng.uniform(0.5, 2.0, (B, n)))
    E = jnp.asarray(rng.uniform(0.5, 2.0, (B, m)))
    w = jnp.asarray(rng.uniform(0.1, 3.0, (B, m)))
    sig = jnp.asarray(rng.uniform(0.5, 1.5, (B, n)))
    rhs = jnp.asarray(rng.standard_normal((B, n)))

    K, nx = ocp.coll.order + 1, ocp.nx
    w_eq = w[:, : ocp.num_eq].reshape(B, -1, K, nx)
    w_g = w[:, ocp.num_eq :].reshape(B, ocp.num_nodes, -1)
    Mband, p_col, m_pp = qs.assemble_banded_M(ocp, sa, w_eq, w_g, D, sig)
    fac = qs.factor_arrow(Mband, p_col, m_pp, ocp.coll.order)
    x = qs.solve_arrow(ocp, fac, ocp.coll.order, rhs)

    A = np.asarray(structure.materialize(ocp, sa))
    Dn = np.asarray(D)
    M_ref = np.einsum("bmi,bm,bmj->bij", A, np.asarray(w), A)
    M_ref = Dn[:, :, None] * M_ref * Dn[:, None, :]
    M_ref += np.stack([np.diag(np.asarray(sig)[b]) for b in range(B)])
    x_ref = np.linalg.solve(M_ref, np.asarray(rhs)[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8, atol=1e-10)


def _planner_qp_data(B=4, soft=True):
    """Real SQP-subproblem QP data from warm-started planner states.

    soft=True additionally returns the per-row l1 penalty weights the SQP
    uses (ops/sqp.py: every nonlinear inequality row soft at weight 10);
    soft=False returns soft_c=None (all rows hard)."""
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    planner = MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1))
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    cur = jnp.concatenate(planner.sample_random_state(k1, batch_shape=(B,)), -1)
    tgt = jnp.concatenate(planner.sample_random_state(k2, batch_shape=(B,)), -1)
    ocp = planner.ocp
    bounds = planner.nlp_bounds(cur, tgt)
    z0 = planner.warm_start_vector(planner.plan_warm_start(cur, tgt))

    c_eq = jax.vmap(ocp.eq_residual)(z0)
    g = jax.vmap(ocp.ineq_residual)(z0)
    h = jax.vmap(ocp.cost_gradient)(z0)
    dt = z0.dtype
    m = ocp.num_eq + ocp.num_ineq
    lb_g = jnp.broadcast_to(bounds.lb_ineq, (B, ocp.num_ineq))
    ub_g = jnp.broadcast_to(bounds.ub_ineq, (B, ocp.num_ineq))
    lc = jnp.concatenate([-c_eq, lb_g - g], axis=-1)
    uc = jnp.concatenate([-c_eq, ub_g - g], axis=-1)
    lx = jnp.broadcast_to(bounds.lb_var, z0.shape) - z0
    ux = jnp.broadcast_to(bounds.ub_var, z0.shape) - z0
    P = jnp.full((B, ocp.num_var), 0.01, dt)
    soft_c = (
        jnp.zeros((B, m), dt).at[:, ocp.num_eq :].set(10.0) if soft else None
    )
    sa = structure.build_structured_A(ocp, z0)
    A = structure.materialize(ocp, sa)
    return ocp, sa, A, P, h, lc, uc, lx, ux, soft_c


def test_planner_solve_structured_matches_xla():
    """Full SQP solve through the planner facade with backend='structured'
    tracks the dense-XLA backend end to end."""
    from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

    B = 3
    key = jax.random.PRNGKey(11)
    k1, k2 = jax.random.split(key)

    def solve(backend):
        planner = MotionPlanner(
            margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
            qp_settings=QPSettings(backend=backend),
        )
        cur = jnp.concatenate(
            planner.sample_random_state(k1, batch_shape=(B,)), -1
        )
        tgt = jnp.concatenate(
            planner.sample_random_state(k2, batch_shape=(B,)), -1
        )
        return planner.solve(cur, tgt)

    ref = solve("xla")
    got = solve("structured")
    np.testing.assert_allclose(
        np.asarray(got.z), np.asarray(ref.z), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.violation), np.asarray(ref.violation), rtol=1e-3, atol=1e-5
    )


@pytest.mark.parametrize("soft", [False, True])
def test_structured_backend_matches_xla_on_planner_qps(soft):
    from mpc_motion_planner_tpu.ops.qp import solve_box_qp

    ocp, sa, A, P, h, lc, uc, lx, ux, soft_c = _planner_qp_data(B=4, soft=soft)
    settings = QPSettings(max_iter=700, kkt_refine=0)
    ref = solve_box_qp(P, h, A, lc, uc, lx, ux, settings, soft_c=soft_c)
    got = qs.solve_box_qp_structured(
        ocp, sa, P, h, lc, uc, lx, ux, settings, soft_c=soft_c
    )

    assert bool(jnp.all(got.converged == ref.converged))
    # identical algorithm + exact solves: iterates should track tightly
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got.iterations), np.asarray(ref.iterations), atol=26
    )


def _planner_soft_x(ocp, B, w=10.0, dt=None):
    """The SQP's elastic variable-box weights (ops/sqp.py
    box_slack_penalty): soft interior-X + U rows, hard endpoints/p."""
    nodes, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    wx = jnp.zeros((ocp.num_var,), dt or jnp.float64)
    wx = wx.at[nx : (nodes - 1) * nx].set(w)
    wx = wx.at[nodes * nx : nodes * (nx + nu)].set(w)
    return jnp.broadcast_to(wx, (B, ocp.num_var))


def test_structured_backend_matches_xla_with_soft_box():
    """soft_x parity: structured vs dense-XLA on real planner QPs with the
    SQP's elastic variable-box weights active."""
    from mpc_motion_planner_tpu.ops.qp import solve_box_qp

    ocp, sa, A, P, h, lc, uc, lx, ux, soft_c = _planner_qp_data(B=4, soft=True)
    soft_x = _planner_soft_x(ocp, 4, dt=P.dtype)
    settings = QPSettings(max_iter=700, kkt_refine=0)
    ref = solve_box_qp(
        P, h, A, lc, uc, lx, ux, settings, soft_c=soft_c, soft_x=soft_x
    )
    got = qs.solve_box_qp_structured(
        ocp, sa, P, h, lc, uc, lx, ux, settings, soft_c=soft_c, soft_x=soft_x
    )
    assert bool(jnp.all(got.converged == ref.converged))
    np.testing.assert_allclose(
        np.asarray(got.x), np.asarray(ref.x), rtol=1e-5, atol=1e-6
    )
    # soft-box duals are bounded by the weight on the soft rows
    soft_rows = np.asarray(soft_x) > 0
    assert np.abs(np.asarray(got.y_box))[soft_rows].max() <= 10.0 + 1e-3
    # hard rows (pinned node 0, terminal node, p) still satisfied by the
    # z-iterate of converged problems to the ADMM tolerance
    conv = np.asarray(got.converged)
    if conv.any():
        x = np.asarray(got.x)
        viol = np.maximum(x - np.asarray(ux), 0.0) + np.maximum(
            np.asarray(lx) - x, 0.0
        )
        assert (viol * ~soft_rows)[conv].max() < 5e-3


def test_structured_backend_solves_planner_qps_to_tolerance():
    ocp, sa, A, P, h, lc, uc, lx, ux, soft_c = _planner_qp_data(B=4, soft=True)
    settings = QPSettings(max_iter=700)
    got = qs.solve_box_qp_structured(
        ocp, sa, P, h, lc, uc, lx, ux, settings, soft_c=soft_c
    )
    # Not every chained-workload QP converges within the reference's
    # 700-iteration budget (a property of the problem, shared with the
    # XLA backend — see the parity test); most must.
    conv = np.asarray(got.converged)
    assert conv.sum() >= 3
    # KKT check: primal feasibility of the returned step where converged.
    # HARD rows (the equality/defect block) must hold to tolerance; soft
    # rows may carry a paid l1 violation, bounded by duals <= weight.
    Ax = np.einsum("bmn,bn->bm", np.asarray(A), np.asarray(got.x))
    viol = np.maximum(Ax - np.asarray(uc), 0.0) + np.maximum(
        np.asarray(lc) - Ax, 0.0
    )
    hard = np.asarray(soft_c) == 0
    assert (viol * hard)[conv].max() < 5e-3
    duals = np.abs(np.asarray(got.y_constraints))
    assert (duals * ~hard)[conv].max() <= 10.0 + 1e-3
