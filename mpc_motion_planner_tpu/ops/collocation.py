"""Chebyshev–Gauss–Lobatto pseudospectral collocation on a segmented spline.

Batched replacement for polyMPC's ``Chebyshev<POLY_ORDER, GAUSS_LOBATTO>``
+ ``Spline<Polynomial, NUM_SEG>`` transcription (/root/reference/mpc_solver/
robot_ocp.hpp:31-36): order-3 polynomials on 6 segments over normalized time
tau in [0, 1] share segment-boundary nodes, giving 6*3+1 = 19 collocation
nodes. Provides the differentiation matrix for defect constraints,
Clenshaw–Curtis quadrature weights, and barycentric interpolation for
``solution_x_at(t)`` / ``solution_u_at(t)`` queries
(/root/reference/mpc_solver/motionPlanner.hpp:106-108).

All matrices are built host-side in float64 numpy and baked as constants; the
runtime functions are pure jnp and vectorize over query points and batches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def cgl_points(order: int) -> np.ndarray:
    """Chebyshev–Gauss–Lobatto points mapped to [0, 1], ascending."""
    x = np.cos(np.pi * np.arange(order + 1) / order)  # 1 .. -1
    return (1.0 - x) / 2.0


def cheb_diff_matrix(order: int) -> np.ndarray:
    """Differentiation matrix on the [0, 1] CGL grid (ascending nodes):
    (D f)(s_i) = f'(s_i) for polynomials up to degree `order`.

    Built from the classic Trefethen matrix on x = cos(j pi / N) with the
    chain rule ds = -dx/2  =>  d/ds = -2 d/dx.
    """
    N = order
    x = np.cos(np.pi * np.arange(N + 1) / N)
    c = np.ones(N + 1)
    c[0] = c[N] = 2.0
    c = c * (-1.0) ** np.arange(N + 1)
    X = np.tile(x, (N + 1, 1)).T
    dX = X - X.T
    D = np.outer(c, 1.0 / c) / (dX + np.eye(N + 1))
    D = D - np.diag(D.sum(axis=1))
    return -2.0 * D


def clenshaw_curtis_weights(order: int) -> np.ndarray:
    """Quadrature weights on the [0, 1] CGL grid (exact for degree<=order)."""
    s = cgl_points(order)
    # Integrate the Lagrange cardinal polynomials exactly with numpy.
    V = np.vander(s, order + 1, increasing=True)  # V[i, k] = s_i^k
    moments = 1.0 / np.arange(1, order + 2)  # integral of s^k on [0,1]
    return np.linalg.solve(V.T, moments)


def barycentric_weights(order: int) -> np.ndarray:
    """Barycentric weights for the CGL grid (up to common scaling)."""
    w = (-1.0) ** np.arange(order + 1)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Collocation:
    """Static transcription data for an order/segment configuration."""

    order: int = dataclasses.field(metadata={"static": True})
    num_segments: int = dataclasses.field(metadata={"static": True})

    time_nodes: jax.Array  # (num_nodes,) global tau grid, ascending in [0,1]
    local_nodes: jax.Array  # (order+1,) local CGL grid on [0,1]
    # (order+1, order+1) d/d tau_global on one segment (local D * num_segments)
    diff_matrix: jax.Array
    quad_weights: jax.Array  # (order+1,) local quadrature weights (sum = 1)
    bary_weights: jax.Array  # (order+1,)

    @property
    def num_nodes(self) -> int:
        return self.order * self.num_segments + 1

    def segment_indices(self) -> np.ndarray:
        """(num_segments, order+1) global node index per segment-local node."""
        o, s = self.order, self.num_segments
        return (np.arange(s)[:, None] * o + np.arange(o + 1)[None, :]).astype(np.int32)

    def astype(self, dtype) -> "Collocation":
        cast = lambda a: jnp.asarray(a, dtype)
        return dataclasses.replace(
            self,
            time_nodes=cast(self.time_nodes),
            local_nodes=cast(self.local_nodes),
            diff_matrix=cast(self.diff_matrix),
            quad_weights=cast(self.quad_weights),
            bary_weights=cast(self.bary_weights),
        )


def make_collocation(order: int = 3, num_segments: int = 6, dtype=None) -> Collocation:
    """Build the transcription constants (defaults match robot_ocp.hpp:31-32)."""
    local = cgl_points(order)
    nodes = []
    for seg in range(num_segments):
        start = seg / num_segments
        pts = start + local / num_segments
        nodes.extend(pts if seg == 0 else pts[1:])
    coll = Collocation(
        order=order,
        num_segments=num_segments,
        time_nodes=np.asarray(nodes),
        local_nodes=local,
        diff_matrix=cheb_diff_matrix(order) * num_segments,
        quad_weights=clenshaw_curtis_weights(order),
        bary_weights=barycentric_weights(order),
    )
    if dtype is not None:
        coll = coll.astype(dtype)
    return coll


def segment_values(coll: Collocation, node_values: jnp.ndarray) -> jnp.ndarray:
    """Gather per-segment node values: (num_nodes, d) -> (S, order+1, d)."""
    idx = jnp.asarray(coll.segment_indices())
    return node_values[idx]


def derivative_at_nodes(coll: Collocation, node_values: jnp.ndarray) -> jnp.ndarray:
    """d/d tau_global of the spline at every segment-local node:
    (num_nodes, d) -> (S, order+1, d)."""
    seg = segment_values(coll, node_values)
    return jnp.einsum("kj,sjd->skd", coll.diff_matrix, seg)


def interpolate(coll: Collocation, node_values: jnp.ndarray, t) -> jnp.ndarray:
    """Barycentric evaluation of the spline at global time(s) t in [0, 1].

    node_values: (num_nodes, d); t: scalar or (...,). Returns (..., d).
    Queries outside [0, 1] are clamped (matching how the reference clamps
    sampling times, motionPlanner.hpp:120-121,132).
    """
    t = jnp.clip(jnp.asarray(t), 0.0, 1.0)
    S = coll.num_segments
    seg = jnp.clip(jnp.floor(t * S).astype(jnp.int32), 0, S - 1)
    s_local = t * S - seg.astype(t.dtype)

    seg_vals = segment_values(coll, node_values)  # (S, o+1, d)
    vals = seg_vals[seg]  # (..., o+1, d)

    diff = s_local[..., None] - coll.local_nodes  # (..., o+1)
    # Exact-node hits: replace the 1/0 by a one-hot selection.
    exact = jnp.abs(diff) < 1e-12
    any_exact = jnp.any(exact, axis=-1, keepdims=True)
    safe_diff = jnp.where(exact, 1.0, diff)
    w = coll.bary_weights / safe_diff  # (..., o+1)
    w = jnp.where(any_exact, exact.astype(w.dtype), w)
    return jnp.einsum("...j,...jd->...d", w, vals) / jnp.sum(w, axis=-1)[..., None]
