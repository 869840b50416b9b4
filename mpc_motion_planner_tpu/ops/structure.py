"""Structured (matrix-free) application of the NLP constraint Jacobian.

The QP constraint matrix of the transcribed minimum-time OCP,

    A = [ A_eq  ]      A_eq   = E_D + p * C_dyn + (-f_rows) e_p^T
        [ A_ineq]      A_ineq = per-node (ng x (nx+nu)) Jacobian blocks

has batch-SHARED structure (ocp.py:33-41): E_D is the Chebyshev
differentiation pattern and C_dyn the (linear) dynamics coupling — both
compile-time constants — while the only per-problem data are the scalar p,
the dynamics values f_rows (the entries of the d/dp column) and the 19 tiny
constraint-Jacobian blocks J. The dense backend materializes A per
problem (488 x 400) and applies it with one matvec per problem.

This module applies A·v and Aᵀ·w WITHOUT materializing A:

* E_D part: one ``(order+1, order+1)`` einsum with the differentiation
  matrix over (batch, segment) — a real batched GEMM with tiny K.
* C_dyn part: an index shuffle scaled by p (f(x, u) = [qdot; u] is linear).
* p column: a rank-1 product with f_rows.
* J blocks: a per-node (ng, nx+nu) contraction batched over (B, nodes).

Cost per application: ~15k flops/problem vs ~390k for the dense matvec, all
in ops whose wide axis is the batch. The
matrix-free boxADMM/PDHG backend in :mod:`.qp` is built on these.

Reference parity: the operator represents the same linearization polyMPC
feeds its boxADMM (/root/reference/mpc_solver/motionPlanner.hpp:10-11,
robot_ocp.hpp:98-163); ``materialize`` reproduces the dense matrix for
tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class StructuredA:
    """Per-problem constraint-Jacobian data (everything else is shared).

    Shapes (B = batch):
      p:       (B,)                 time parameter at the linearization point
      f_rows:  (B, num_eq)          dynamics values: -f_rows is the p column
      J:       (B, nodes, ng, nx+nu) exact per-node constraint Jacobians
    """

    p: jax.Array
    f_rows: jax.Array
    J: jax.Array


@lru_cache(maxsize=None)
def _static_indices(order: int, num_segments: int):
    """Host-side gather/scatter maps between global nodes and the
    (segment, local-node) grid. Every global node appears in at most two
    segments (boundary nodes are shared), so the segment->node scatter-add
    is two gathers + one add instead of a scatter."""
    K = order + 1
    seg_idx = (
        np.arange(num_segments)[:, None] * order + np.arange(K)[None, :]
    )  # (S, K) global node per (segment, local node)
    nodes = order * num_segments + 1
    flat = seg_idx.reshape(-1)  # (S*K,)
    first = np.zeros(nodes, np.int32)
    second = np.zeros(nodes, np.int32)
    valid2 = np.zeros(nodes, np.float64)
    for n in range(nodes):
        hits = np.nonzero(flat == n)[0]
        first[n] = hits[0]
        second[n] = hits[-1]
        valid2[n] = 1.0 if len(hits) > 1 else 0.0
    return seg_idx, first, second, valid2


def _dims(ocp):
    return (
        ocp.coll.order,
        ocp.coll.num_segments,
        ocp.num_nodes,
        ocp.nx,
        ocp.nu,
        ocp.ng,
        ocp.num_eq,
    )


def build_structured_A(ocp, z, J=None) -> StructuredA:
    """Exact linearization data at the (batched) iterate z — the
    matrix-free equivalent of ``vmap(ocp.constraint_matrix)(z)``.

    J: optionally the precomputed (B, nodes, ng, nx+nu) per-node
    Jacobians (e.g. from ``ocp.linearize_constraints_batch``, which the
    SQP shares with the residual evaluation)."""
    X, U, p = ocp.unpack(z)
    seg_idx, *_ = _static_indices(ocp.coll.order, ocp.coll.num_segments)
    f = ocp.dynamics(X, U)  # (B, nodes, nx)
    f_rows = f[:, jnp.asarray(seg_idx.reshape(-1))].reshape(z.shape[0], -1)
    if J is None:
        J = jax.vmap(ocp.node_constraint_jacobians)(z)  # (B, nodes, ng, nx+nu)
    return StructuredA(p=p, f_rows=f_rows, J=J)


def apply_A(ocp, sa: StructuredA, v):
    """A @ v for a batch: v (B, num_var) -> (B, num_eq + num_ineq)."""
    order, S, nodes, nx, nu, ng, num_eq = _dims(ocp)
    B = v.shape[0]
    vX, vU, vp = ocp.unpack(v)
    seg_idx, *_ = _static_indices(order, S)
    idx = jnp.asarray(seg_idx)  # (S, K)

    # equality rows: E_D + p*C_dyn + p-column
    vX_seg = vX[:, idx]  # (B, S, K, nx)
    dX = jnp.einsum(
        "kj,bsji->bski", ocp.coll.diff_matrix.astype(v.dtype), vX_seg
    )
    f_lin = ocp.dynamics(vX, vU)  # (B, nodes, nx) — f is linear
    eq = (dX - sa.p[:, None, None, None] * f_lin[:, idx]).reshape(B, num_eq)
    eq = eq - sa.f_rows * vp[:, None]

    # inequality rows: per-node J blocks
    v_nodes = jnp.concatenate([vX, vU], axis=-1)  # (B, nodes, nx+nu)
    g = jnp.einsum("bngc,bnc->bng", sa.J, v_nodes)
    return jnp.concatenate([eq, g.reshape(B, -1)], axis=-1)


def apply_AT(ocp, sa: StructuredA, w):
    """A^T @ w for a batch: w (B, num_eq + num_ineq) -> (B, num_var)."""
    order, S, nodes, nx, nu, ng, num_eq = _dims(ocp)
    B = w.shape[0]
    K = order + 1
    nq = ocp.nq
    seg_idx, first, second, valid2 = _static_indices(order, S)
    i1, i2 = jnp.asarray(first), jnp.asarray(second)
    v2 = jnp.asarray(valid2, w.dtype)

    w_eq = w[:, :num_eq].reshape(B, S, K, nx)
    w_g = w[:, num_eq:].reshape(B, nodes, ng)

    def seg_to_nodes(c):  # (B, S, K, d) -> (B, nodes, d) scatter-add
        cf = c.reshape(B, S * K, -1)
        return cf[:, i1] + v2[None, :, None] * cf[:, i2]

    # E_D^T: D^T over local nodes, then segment->node accumulation
    X_out = seg_to_nodes(
        jnp.einsum("kj,bski->bsji", ocp.coll.diff_matrix.astype(w.dtype), w_eq)
    )

    # C_dyn^T: row (s,k,i) has -p at (node qdot_i) for i<nq, else (node u_{i-nq})
    w_nodes = seg_to_nodes(w_eq)  # (B, nodes, nx)
    X_out = X_out.at[..., nq:].add(-sa.p[:, None, None] * w_nodes[..., :nq])
    U_out = -sa.p[:, None, None] * w_nodes[..., nq:]

    # J^T blocks
    vn = jnp.einsum("bngc,bng->bnc", sa.J, w_g)  # (B, nodes, nx+nu)
    X_out = X_out + vn[..., :nx]
    U_out = U_out + vn[..., nx:]

    # p column
    p_out = -jnp.einsum("be,be->b", sa.f_rows, w[:, :num_eq])

    return jnp.concatenate(
        [X_out.reshape(B, -1), U_out.reshape(B, -1), p_out[:, None]], axis=-1
    )


def materialize(ocp, sa: StructuredA, dtype=None):
    """Dense (B, m, n) matrix equal to the structured operator — for tests
    and for the once-per-solve Ruiz equilibration."""
    B = sa.p.shape[0]
    n = ocp.num_var
    dt = dtype or sa.f_rows.dtype
    eye = jnp.eye(n, dtype=dt)
    cols = jax.vmap(
        lambda e: apply_A(ocp, sa, jnp.broadcast_to(e, (B, n)))
    )(eye)  # (n, B, m)
    return jnp.transpose(cols, (1, 2, 0))


def operator_norm(ocp, sa: StructuredA, D, E, iters: int = 40, key=None):
    """Per-problem 2-norm estimate of the SCALED operator E A D by power
    iteration on (E A D)^T (E A D) — matrix-free, once per solve."""
    B = sa.p.shape[0]
    n = ocp.num_var
    dt = sa.f_rows.dtype
    if key is None:
        key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (B, n), dt)

    def body(_, v):
        v = v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30
        )
        Av = E * apply_A(ocp, sa, D * v)
        return D * apply_AT(ocp, sa, E * Av)

    v = jax.lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.maximum(jnp.linalg.norm(v, axis=-1), 1e-30))
