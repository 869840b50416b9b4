"""Minimum-time OCP transcription to a fixed-shape NLP.

Batched re-design of the reference's ``minTime_ocp``
(/root/reference/mpc_solver/robot_ocp.hpp) + polyMPC's ``ContinuousOCP``
transcription: NX=14 (q, qdot), NU=7 (qddot), NP=1 (final time t_f), NG=8
(7 RNEA torques + tool height) on a 19-node Chebyshev–Gauss–Lobatto spline
(order 3 x 6 segments; robot_ocp.hpp:31-38).

Decision vector layout (VAR = nodes*nx + nodes*nu + 1 = 400):
    z = [X_0, ..., X_18, U_0, ..., U_18, p]
with X_k = [q_k (7), qdot_k (7)] — matching polyMPC's x_guess/u_guess/p_guess
packing (motionPlanner.cpp:162-174).

Dynamics (robot_ocp.hpp:56-73): dx/dtau = p * f(x, u) with
f = [qdot; u] — time is normalized to [0, 1] and p is the (free) final time.

Equality constraints: collocation defects imposed at ALL order+1 local
nodes of every segment (6*4*14 = 336 rows, Gauss–Lobatto collocation as in
polyMPC's ContinuousOCP). Interior segment-boundary nodes therefore carry a
defect row from BOTH adjacent segments, which enforces C1 continuity of the
state spline (left and right slopes both equal t_f*f at the shared node) —
without it the spline slope is free at segment starts and the sampled
trajectory's velocity/acceleration disagree between nodes. The initial
state is pinned via variable bounds (lb = ub) on node 0, the terminal state
via the target +- eps box on node 18, mirroring polyMPC's
initial_conditions / final_state_bounds mechanism.

Inequality constraints (robot_ocp.hpp:80-96): per node,
g = [tau(q, qdot, qddot) (7), z_tool(q) (1)], bounds
[-margin*tau_max, min_height] .. [margin*tau_max, inf]
(motionPlanner.cpp:92-100).

Jacobian structure exploited for the batch: A_eq = E_D + p * C_dyn + dfp
where E_D (the differentiation-matrix pattern) and C_dyn (the
state/control coupling pattern) are compile-time constants shared by every
trajectory in a batch; only the (ng x nx+nu) per-node constraint Jacobians
(RNEA partials + height row) are per-trajectory, computed exactly with
jacfwd.

d tau/d p: the reference fills a nonzero column (robot_ocp.hpp:124,138:
dtau/dv qdot + dtau/da qddot) even though tau does not depend on p in
this formulation; this implementation defaults to the mathematically
correct zero. MEASURED immaterial (A/B on the chained workload,
B=128, dense backend, `TranscribedOCP.tau_p_column` replaying the
reference fill; KERNELS.md): identical
convergence (0.9883 both arms), violation (p50 0.423, p90 5.74 both),
terminal error and line-search step sizes; the iterates differ by
max-norm p50 0.018 (different paths to equivalent-quality solutions).
The zero column therefore stays the default, and the last semantic gap
between the two solvers' SQP steps is pinned closed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models.robot import Frame, RobotModel
from .ops import kinematics, rnea
from .ops.collocation import Collocation, derivative_at_nodes, make_collocation


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TranscribedOCP:
    """Static transcription of the minimum-time OCP for one robot."""

    model: RobotModel
    coll: Collocation
    tool_frame: Frame

    # Constant Jacobian patterns (num_eq, num_var)
    eq_diff_pattern: jax.Array  # E_D: differentiation-matrix block
    eq_dyn_pattern: jax.Array  # C_dyn: -(df/dx, df/du) coupling, scaled by p

    # A/B flag for the reference's d tau/d p linearization column
    # (robot_ocp.hpp:124,138): the reference fills the torque rows' p
    # column with dtau/dv*qdot + dtau/da*qddot even though tau does not
    # depend on p in this formulation (the height row's p entry stays 0,
    # robot_ocp.hpp:158-160). False (default) uses the mathematically
    # correct zero. Supported by the DENSE ('xla') backend only — the
    # structured operators hard-code the correct zero column; the flag
    # exists to MEASURE whether the reference's wrong-but-used column
    # changes its SQP steps materially (result recorded in KERNELS.md).
    tau_p_column: bool = dataclasses.field(
        default=False, metadata={"static": True}
    )

    @property
    def nq(self) -> int:
        return self.model.nq

    @property
    def nx(self) -> int:
        return 2 * self.model.nq

    @property
    def nu(self) -> int:
        return self.model.nq

    @property
    def ng(self) -> int:
        return self.model.nq + 1

    @property
    def num_nodes(self) -> int:
        return self.coll.num_nodes

    @property
    def num_var(self) -> int:
        return self.num_nodes * (self.nx + self.nu) + 1

    @property
    def num_eq(self) -> int:
        return self.coll.num_segments * (self.coll.order + 1) * self.nx

    @property
    def num_ineq(self) -> int:
        return self.num_nodes * self.ng

    # ---------------- packing ----------------

    def pack(self, X, U, p):
        """(nodes, nx), (nodes, nu), (1,) -> (num_var,)."""
        return jnp.concatenate([X.reshape(-1), U.reshape(-1), jnp.atleast_1d(p)])

    def unpack(self, z):
        n, nx, nu = self.num_nodes, self.nx, self.nu
        X = z[..., : n * nx].reshape(*z.shape[:-1], n, nx)
        U = z[..., n * nx : n * (nx + nu)].reshape(*z.shape[:-1], n, nu)
        p = z[..., -1]
        return X, U, p

    # ---------------- NLP callbacks ----------------

    def cost(self, z):
        """Mayer term = p (pure minimum time, robot_ocp.hpp:202-213)."""
        return z[..., -1]

    def cost_gradient(self, z):
        g = jnp.zeros_like(z)
        return g.at[..., -1].set(1.0)

    def dynamics(self, x, u):
        """Unscaled f(x, u) = [qdot; u]; dx/dtau = p * f."""
        nq = self.nq
        return jnp.concatenate([x[..., nq:], u], axis=-1)

    def eq_residual(self, z):
        """Collocation defects at every segment-local node, shape (num_eq,)."""
        X, U, p = self.unpack(z)
        dX = derivative_at_nodes(self.coll, X)  # (S, order+1, nx)
        f = self.dynamics(X, U)  # (nodes, nx)
        idx = jnp.asarray(self.coll.segment_indices())  # (S, order+1)
        return (dX - p * f[idx]).reshape(-1)

    def eq_residual_quadratic(self, z, d):
        """Exact quadratic expansion of the defects along a step direction.

        The defect c(z) = D.X - p f(X, U) is bilinear in (p, [X; U]), so
        c(z + a d) = c0 + a c1 + a^2 c2 EXACTLY for every step size a —
        the merit line search evaluates all its candidates from these
        three (num_eq,) vectors instead of re-running the full defect
        chain at line_search_max_iter x batch. Returns (c0, c1, c2).
        """
        X, U, p = self.unpack(z)
        dX_d, dU_d, dp = self.unpack(d)
        idx = jnp.asarray(self.coll.segment_indices())
        f_z = self.dynamics(X, U)[idx]  # (S, order+1, nx)
        f_d = self.dynamics(dX_d, dU_d)[idx]
        c0 = derivative_at_nodes(self.coll, X) - p * f_z
        c1 = derivative_at_nodes(self.coll, dX_d) - p * f_d - dp * f_z
        c2 = -dp * f_d
        return c0.reshape(-1), c1.reshape(-1), c2.reshape(-1)

    def node_constraints(self, x, u):
        """Per-node inequality g = [tau (nq), tool height] (robot_ocp.hpp:91)."""
        nq = self.nq
        tau = rnea.rnea(self.model, x[:nq], x[nq:], u)
        height = kinematics.frame_height(self.model, x[:nq], self.tool_frame)
        return jnp.concatenate([tau, jnp.atleast_1d(height)])

    def ineq_residual(self, z):
        """(num_ineq,) = node-major stacked g values."""
        X, U, _ = self.unpack(z)
        g = jax.vmap(self.node_constraints)(X, U)  # (nodes, ng)
        return g.reshape(-1)

    # ---- batched evaluation ----

    def ineq_residual_batch(self, z):
        """(B, num_var) -> (B, num_ineq): batched node-major g values."""
        return jax.vmap(self.ineq_residual)(z)

    def linearize_constraints_batch(self, z):
        """(B, num_var) -> (g (B, num_ineq), J (B, nodes, ng, nx+nu)):
        batched constraint values + exact per-node Jacobians."""
        return (
            jax.vmap(self.ineq_residual)(z),
            jax.vmap(self.node_constraint_jacobians)(z),
        )

    def node_constraint_jacobians(self, z):
        """Exact per-node Jacobians dg/d[x, u], shape (nodes, ng, nx+nu).

        jacfwd through RNEA+FK — the counterpart of the analytic Pinocchio
        partial injection at robot_ocp.hpp:98-163.
        """
        X, U, _ = self.unpack(z)
        nx = self.nx

        def g_of(xu):
            return self.node_constraints(xu[:nx], xu[nx:])

        return jax.vmap(jax.jacfwd(g_of))(jnp.concatenate([X, U], axis=-1))

    def eq_jacobian(self, z):
        """Dense (num_eq, num_var) defect Jacobian (exact)."""
        X, U, p = self.unpack(z)
        A = self.eq_diff_pattern + p * self.eq_dyn_pattern
        idx = jnp.asarray(self.coll.segment_indices()).reshape(-1)
        f_rows = self.dynamics(X, U)[idx].reshape(-1)  # (num_eq,)
        return A.at[:, -1].add(-f_rows)

    def ineq_jacobian(self, z):
        """Dense (num_ineq, num_var) constraint Jacobian (exact; dg/dp = 0
        unless `tau_p_column` replays the reference's nonzero fill)."""
        J = self.node_constraint_jacobians(z)  # (nodes, ng, nx+nu)
        rows, cols = _ineq_scatter_indices(self)
        A = jnp.zeros((self.num_ineq, self.num_var), dtype=z.dtype)
        A = A.at[rows, cols].set(J.reshape(-1))
        if self.tau_p_column:
            # Reference parity experiment (robot_ocp.hpp:124,138): torque
            # rows' p column = dtau/dv qdot + dtau/da qddot, one jvp of
            # tau(q, ., .) in direction (qdot, qddot); height rows stay 0.
            X, U, _ = self.unpack(z)
            nq = self.nq

            def col(x, u):
                tau_of = lambda v, a: rnea.rnea(self.model, x[:nq], v, a)
                _, dtau = jax.jvp(tau_of, (x[nq:], u), (x[nq:], u))
                return dtau  # (nq,)

            dtau_p = jax.vmap(col)(X, U)  # (nodes, nq)
            trows = (
                jnp.arange(self.num_nodes)[:, None] * self.ng
                + jnp.arange(nq)[None, :]
            ).reshape(-1)
            A = A.at[trows, -1].set(dtau_p.reshape(-1))
        return A

    def constraint_matrix(self, z):
        """Stacked (num_eq + num_ineq, num_var) linearization."""
        return jnp.concatenate([self.eq_jacobian(z), self.ineq_jacobian(z)], axis=0)


# ---------------- construction ----------------


def _build_constant_patterns(coll: Collocation, nx: int, nu: int):
    """Host-side E_D and C_dyn (float64 numpy)."""
    S, order = coll.num_segments, coll.order
    nodes = order * S + 1
    num_eq = S * (order + 1) * nx
    num_var = nodes * (nx + nu) + 1
    D = np.asarray(coll.diff_matrix, dtype=np.float64)
    seg_idx = coll.segment_indices()

    E = np.zeros((num_eq, num_var))
    C = np.zeros((num_eq, num_var))
    nq = nx // 2
    u_base = nodes * nx
    for s in range(S):
        for k in range(order + 1):
            node_k = int(seg_idx[s, k])
            for i in range(nx):
                r = (s * (order + 1) + k) * nx + i
                for j in range(order + 1):
                    E[r, int(seg_idx[s, j]) * nx + i] += D[k, j]
                # -p * df/d(x,u): f_i = x_{i+nq} for i < nq else u_{i-nq}
                if i < nq:
                    C[r, node_k * nx + i + nq] += -1.0
                else:
                    C[r, u_base + node_k * nu + (i - nq)] += -1.0
    return E, C


def _ineq_scatter_indices(ocp: TranscribedOCP):
    """Flat (rows, cols) mapping (nodes, ng, nx+nu) -> dense A_ineq."""
    n, ng, nx, nu = ocp.num_nodes, ocp.ng, ocp.nx, ocp.nu
    node = np.arange(n)[:, None, None]
    c = np.arange(ng)[None, :, None]
    d = np.arange(nx + nu)[None, None, :]
    rows = np.broadcast_to(node * ng + c, (n, ng, nx + nu))
    cols = np.broadcast_to(
        np.where(d < nx, node * nx + d, n * nx + node * nu + (d - nx)),
        (n, ng, nx + nu),
    )
    return jnp.asarray(rows.reshape(-1)), jnp.asarray(cols.reshape(-1))


def make_ocp(
    model: RobotModel,
    tool_frame_name: str = "panda_tool",
    order: int = 3,
    num_segments: int = 6,
    dtype=None,
    tau_p_column: bool = False,
) -> TranscribedOCP:
    coll = make_collocation(order, num_segments, dtype=dtype)
    nx, nu = 2 * model.nq, model.nq
    E, C = _build_constant_patterns(coll, nx, nu)
    if dtype is not None:
        model = model.astype(dtype)
        E = E.astype(dtype)
        C = C.astype(dtype)
    return TranscribedOCP(
        model=model,
        coll=coll,
        tool_frame=model.frame(tool_frame_name),
        eq_diff_pattern=jnp.asarray(E),
        eq_dyn_pattern=jnp.asarray(C),
        tau_p_column=tau_p_column,
    )


# ---------------- bounds assembly ----------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NLPBounds:
    """Variable and constraint boxes for one solve (all batched-friendly)."""

    lb_var: jax.Array  # (num_var,)
    ub_var: jax.Array
    lb_ineq: jax.Array  # (num_ineq,)
    ub_ineq: jax.Array


def assemble_bounds(
    ocp: TranscribedOCP,
    current_state,
    target_state,
    state_lb,
    state_ub,
    control_lb,
    control_ub,
    param_lb,
    param_ub,
    ineq_lb,
    ineq_ub,
    target_eps: float = 1e-2,
) -> NLPBounds:
    """Mirror of the polyMPC bound plumbing: interior nodes get the state
    box, node 0 is pinned to the current state (initial_conditions), node
    N-1 gets target +- eps (final_state_bounds, motionPlanner.cpp:33), all
    nodes share the control box and the nonlinear-constraint box."""
    n, nx, nu = ocp.num_nodes, ocp.nx, ocp.nu
    dt = current_state.dtype

    lbX = jnp.tile(state_lb, (n, 1))
    ubX = jnp.tile(state_ub, (n, 1))
    lbX = lbX.at[0].set(current_state).at[n - 1].set(target_state - target_eps)
    ubX = ubX.at[0].set(current_state).at[n - 1].set(target_state + target_eps)

    lbU = jnp.tile(control_lb, (n, 1))
    ubU = jnp.tile(control_ub, (n, 1))

    lb = jnp.concatenate([lbX.reshape(-1), lbU.reshape(-1), jnp.atleast_1d(jnp.asarray(param_lb, dt))])
    ub = jnp.concatenate([ubX.reshape(-1), ubU.reshape(-1), jnp.atleast_1d(jnp.asarray(param_ub, dt))])

    lbg = jnp.tile(ineq_lb, (n,))
    ubg = jnp.tile(ineq_ub, (n,))
    return NLPBounds(lb_var=lb, ub_var=ub, lb_ineq=lbg, ub_ineq=ubg)
