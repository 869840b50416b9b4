"""Forward kinematics, frame Jacobians, task-space velocity maps and IK.

Batched replacement for the kinematics slice of Pinocchio used by the
reference (``forwardKinematics``, ``updateFramePlacement``,
``computeFrameJacobian``, damped-LS IK — /root/reference/robot_utils/
pandaWrapper.cpp). Everything is differentiable, vmappable and shape-static;
the chain length (7) is a compile-time constant so loops unroll.

Jacobian row ordering is pinocchio's: rows 0-2 linear, rows 3-5 angular.
``frame_jacobian`` returns the LOCAL_WORLD_ALIGNED Jacobian, i.e. what the
reference computes by left-multiplying the LOCAL Jacobian with
blockdiag(R, R) (pandaWrapper.cpp:69-73).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..models.robot import Frame, PRISMATIC, RobotModel
from . import spatial


def fk(model: RobotModel, q) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World placements of every joint frame.

    Returns ``(R, p)`` with shapes ``(nj, 3, 3)`` and ``(nj, 3)``; entry ``i``
    is the world placement of joint ``i``'s frame (pinocchio ``data.oMi[i+1]``).
    """
    Rs, ps = [], []
    eye = jnp.eye(3, dtype=model.tree_rotation.dtype)
    zero = jnp.zeros(3, dtype=model.tree_translation.dtype)
    par = model.parent_indices()
    for i, jtype in enumerate(model.joint_types):
        Rp, pp = (Rs[par[i]], ps[par[i]]) if par[i] >= 0 else (eye, zero)
        R, p = spatial.compose(Rp, pp, model.tree_rotation[i], model.tree_translation[i])
        if jtype == PRISMATIC:
            p = p + R @ (model.axis[i] * q[i])
        else:
            R = R @ spatial.axis_angle_to_matrix(model.axis[i], q[i])
        Rs.append(R)
        ps.append(p)
    return jnp.stack(Rs), jnp.stack(ps)


def frame_placement(model: RobotModel, q, frame: Frame):
    """World placement of a named operational frame (``data.oMf``)."""
    R, p = fk(model, q)
    return spatial.compose(R[frame.parent_joint], p[frame.parent_joint], frame.rotation, frame.translation)


def frame_height(model: RobotModel, q, frame: Frame):
    """z-coordinate of the frame origin (the OCP's table constraint,
    robot_ocp.hpp:91)."""
    _, p = frame_placement(model, q, frame)
    return p[2]


def _world_axes(model: RobotModel, R, p):
    """Per-joint world axis direction and origin for Jacobian columns."""
    axes = jnp.einsum("nij,nj->ni", R, model.axis)
    return axes, p


def frame_jacobian(model: RobotModel, q, frame: Frame) -> jnp.ndarray:
    """LOCAL_WORLD_ALIGNED frame Jacobian, shape (6, nq), rows [linear; angular].

    Column i for a revolute joint with world axis a_i through point p_i:
    linear = a_i x (p_f - p_i), angular = a_i. For a prismatic joint:
    linear = a_i, angular = 0.
    """
    R, p = fk(model, q)
    Rf, pf = spatial.compose(
        R[frame.parent_joint], p[frame.parent_joint], frame.rotation, frame.translation
    )
    axes, origins = _world_axes(model, R, p)
    lin_rev = jnp.cross(axes, pf[None, :] - origins)
    is_prismatic = jnp.asarray(
        [jt == PRISMATIC for jt in model.joint_types], dtype=bool
    )[:, None]
    lin = jnp.where(is_prismatic, axes, lin_rev)
    ang = jnp.where(is_prismatic, jnp.zeros_like(axes), axes)
    # Tree support: only the frame's ancestor joints move it — zero the
    # other columns (a no-op mask for serial chains).
    if not model.is_serial:
        anc = jnp.asarray(model.ancestor_mask(frame.parent_joint), bool)[:, None]
        lin = jnp.where(anc, lin, 0.0)
        ang = jnp.where(anc, ang, 0.0)
    return jnp.concatenate([lin.T, ang.T], axis=0)


def frame_jacobian_local(model: RobotModel, q, frame: Frame) -> jnp.ndarray:
    """LOCAL frame Jacobian (pinocchio's computeFrameJacobian default),
    as used by the reference IK loop (pandaWrapper.cpp:46)."""
    Rf, _ = frame_placement(model, q, frame)
    J = frame_jacobian(model, q, frame)
    return jnp.concatenate([Rf.T @ J[:3], Rf.T @ J[3:]], axis=0)


def forward_velocities(model: RobotModel, q, qdot, frame: Frame) -> jnp.ndarray:
    """Task-space velocity [linear; angular] of the frame
    (pandaWrapper.cpp:90-107)."""
    return frame_jacobian(model, q, frame) @ qdot


def inverse_velocities(
    model: RobotModel, q, linear_velocity, angular_velocity, frame: Frame, damp=1e-5
) -> jnp.ndarray:
    """Damped least-squares joint velocities realizing a task velocity
    (pandaWrapper.cpp:60-88): qdot = J^T (J J^T + damp I)^-1 v."""
    J = frame_jacobian(model, q, frame)
    v = jnp.concatenate([linear_velocity, angular_velocity])
    JJt = J @ J.T + damp * jnp.eye(6, dtype=J.dtype)
    return J.T @ jnp.linalg.solve(JJt, v)


def integrate(model: RobotModel, q, v):
    """Configuration integration; for revolute/prismatic chains this is
    plain addition (pinocchio::integrate on R^n)."""
    return q + v


def inverse_kinematics(
    model: RobotModel,
    q0,
    target_rotation,
    target_translation,
    frame: Frame,
    eps: float = 1e-4,
    max_iters: int = 1000,
    dt: float = 1e-1,
    damp: float = 1e-2,
):
    """Damped least-squares IK, mirroring pandaWrapper.cpp:14-58.

    Iterates q <- q + dt * v with v = -J^T (J J^T + damp I)^-1 log6(dMf),
    where dMf = oMdes^-1 o oMf and J is the LOCAL frame Jacobian. Runs a
    fixed `max_iters` iterations with a convergence mask (batched-friendly);
    returns ``(q, converged)``.
    """
    import jax

    Rd_inv, pd_inv = spatial.inverse(target_rotation, target_translation)

    def error(q):
        Rf, pf = frame_placement(model, q, frame)
        R_err, p_err = spatial.compose(Rd_inv, pd_inv, Rf, pf)
        return spatial.log6(R_err, p_err)

    def body(carry, _):
        q, done = carry
        err = error(q)
        done = done | (jnp.linalg.norm(err) < eps)
        J = frame_jacobian_local(model, q, frame)
        JJt = J @ J.T + damp * jnp.eye(6, dtype=J.dtype)
        v = -J.T @ jnp.linalg.solve(JJt, err)
        q_new = jnp.where(done, q, integrate(model, q, v * dt))
        return (q_new, done), None

    (q, done), _ = jax.lax.scan(
        body, (q0, jnp.asarray(False)), None, length=max_iters
    )
    done = done | (jnp.linalg.norm(error(q)) < eps)
    return q, done
