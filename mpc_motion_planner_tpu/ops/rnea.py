"""Rigid-body dynamics: RNEA inverse dynamics, mass matrix, energies,
and analytic-quality derivatives.

Batched replacement for the Pinocchio algorithms the reference OCP uses
(``rnea``, ``computeRNEADerivatives``, ``crba`` — /root/reference/mpc_solver/
robot_ocp.hpp:86-141). The recursion runs in link coordinates with
Featherstone [angular; linear] spatial vectors; the chain length is a
compile-time constant so the loops unroll into straight-line code that XLA
fuses aggressively. Everything vmaps over arbitrary leading batch axes at
call sites.

Matching pinocchio semantics: URDF joint damping/friction are NOT applied
(plain ``pinocchio::rnea`` ignores them, see SURVEY.md §2.2).

Derivatives are exact: obtained with ``jax.jacfwd`` through the recursion
(forward-mode over a 21-dim input of a cheap function), which is the
analogue of pinocchio's hand-derived Lie-algebraic partials.
Validated against energy-based Lagrangian dynamics and finite differences in
``tests/test_rnea.py`` (the reference's only derivative check is the
``test_develop/test_rnea_derivatives.cpp`` experiment).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.robot import PRISMATIC, RobotModel
from . import spatial


def _joint_transform(model: RobotModel, i: int, qi):
    """(E, r): rotation parent->joint-i coords and joint-i origin in parent."""
    if model.joint_types[i] == PRISMATIC:
        R_pi = model.tree_rotation[i]
        r = model.tree_translation[i] + R_pi @ (model.axis[i] * qi)
    else:
        R_pi = model.tree_rotation[i] @ spatial.axis_angle_to_matrix(model.axis[i], qi)
        r = model.tree_translation[i]
    return R_pi.T, r


def _joint_motion(model: RobotModel, i: int, dtype):
    """Joint motion subspace S_i as an (angular, linear) pair in frame i."""
    ax = model.axis[i].astype(dtype)
    zero = jnp.zeros(3, dtype=dtype)
    if model.joint_types[i] == PRISMATIC:
        return zero, ax
    return ax, zero


def rnea(model: RobotModel, q, qdot, qddot) -> jnp.ndarray:
    """Inverse dynamics: joint torques tau(q, qdot, qddot) with gravity.

    Recursive Newton-Euler in link coordinates (two sweeps over the chain).
    """
    dtype = q.dtype
    nj = model.nq
    par = model.parent_indices()

    zero3 = jnp.zeros(3, dtype=dtype)
    # Base acceleration trick: a_0 = [0; -g] makes gravity flow through the
    # recursion without explicit gravity wrenches.
    base_a = (zero3, -model.gravity.astype(dtype))

    Es, rs, vs, accs = [], [], [], []
    for i in range(nj):
        E, r = _joint_transform(model, i, q[i])
        s_w, s_v = _joint_motion(model, i, dtype)
        vp = vs[par[i]] if par[i] >= 0 else (zero3, zero3)
        ap = accs[par[i]] if par[i] >= 0 else base_a

        v_w, v_v = spatial.transform_motion(E, r, *vp)
        v_w = v_w + s_w * qdot[i]
        v_v = v_v + s_v * qdot[i]

        a_w, a_v = spatial.transform_motion(E, r, *ap)
        c_w, c_v = spatial.cross_motion(v_w, v_v, s_w * qdot[i], s_v * qdot[i])
        a_w = a_w + s_w * qddot[i] + c_w
        a_v = a_v + s_v * qddot[i] + c_v

        Es.append(E)
        rs.append(r)
        vs.append((v_w, v_v))
        accs.append((a_w, a_v))

    # Backward sweep in reverse topological order: each joint's subtree
    # wrench projects onto its motion subspace, then transforms into the
    # parent's slot (fs[i] accumulates joint i's own body wrench plus all
    # already-processed children's back-transformed wrenches).
    taus = [None] * nj
    fs = [(zero3, zero3)] * nj
    for i in range(nj - 1, -1, -1):
        vw, vv = vs[i]
        aw, av = accs[i]
        Iw, Iv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], aw, av)
        hw, hv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], vw, vv)
        bw, bv = spatial.cross_force(vw, vv, hw, hv)
        f_w = fs[i][0] + Iw + bw
        f_v = fs[i][1] + Iv + bv

        s_w, s_v = _joint_motion(model, i, dtype)
        taus[i] = jnp.dot(s_w, f_w) + jnp.dot(s_v, f_v)

        if par[i] >= 0:
            pw, pv = spatial.transform_force_back(Es[i], rs[i], f_w, f_v)
            fs[par[i]] = (fs[par[i]][0] + pw, fs[par[i]][1] + pv)

    return jnp.stack(taus)


def rnea_derivatives(model: RobotModel, q, qdot, qddot):
    """Exact partials (dtau/dq, dtau/dqdot, dtau/dqddot).

    The equivalent of ``pinocchio::computeRNEADerivatives``
    (robot_ocp.hpp:118); dtau/dqddot equals the symmetrized CRBA mass matrix
    the reference substitutes at robot_ocp.hpp:121-136.
    """
    jac = jax.jacfwd(lambda args: rnea(model, *args))((q, qdot, qddot))
    return jac


def crba(model: RobotModel, q) -> jnp.ndarray:
    """Joint-space mass matrix M(q) (pinocchio::crba + symmetrization,
    robot_ocp.hpp:121-122).

    Computed as dtau/dqddot at zero velocity and zero gravity — exactly the
    composite-rigid-body mass matrix, since tau is linear in qddot.
    """
    import dataclasses

    zero_g = dataclasses.replace(model, gravity=jnp.zeros(3, dtype=model.gravity.dtype))
    z = jnp.zeros_like(q)
    M = jax.jacfwd(lambda a: rnea(zero_g, q, z, a))(z)
    return 0.5 * (M + M.T)


def nonlinear_effects(model: RobotModel, q, qdot) -> jnp.ndarray:
    """Coriolis + centrifugal + gravity torques: tau(q, qdot, 0)."""
    return rnea(model, q, qdot, jnp.zeros_like(q))


def kinetic_energy(model: RobotModel, q, qdot):
    """Total kinetic energy, computed from the forward velocity sweep only.

    Used as an independent oracle for RNEA (Lagrangian vs Newton-Euler).
    """
    dtype = q.dtype
    zero3 = jnp.zeros(3, dtype=dtype)
    par = model.parent_indices()
    vs = []
    ke = jnp.zeros((), dtype=dtype)
    for i in range(model.nq):
        E, r = _joint_transform(model, i, q[i])
        s_w, s_v = _joint_motion(model, i, dtype)
        vp = vs[par[i]] if par[i] >= 0 else (zero3, zero3)
        v_w, v_v = spatial.transform_motion(E, r, *vp)
        v_w = v_w + s_w * qdot[i]
        v_v = v_v + s_v * qdot[i]
        vs.append((v_w, v_v))
        hw, hv = spatial.inertia_apply(model.mass[i], model.com[i], model.inertia[i], v_w, v_v)
        ke = ke + 0.5 * (jnp.dot(v_w, hw) + jnp.dot(v_v, hv))
    return ke


def potential_energy(model: RobotModel, q):
    """Total gravitational potential energy (world-frame com heights)."""
    from . import kinematics

    R, p = kinematics.fk(model, q)
    com_world = p + jnp.einsum("nij,nj->ni", R, model.com)
    return -jnp.sum(model.mass * (com_world @ model.gravity.astype(q.dtype)))
