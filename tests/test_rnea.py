import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.models.robot import REVOLUTE, RobotModel
from mpc_motion_planner_tpu.models.panda import make_panda_model
from mpc_motion_planner_tpu.ops import rnea as rnea_mod
from mpc_motion_planner_tpu.ops.rnea import (
    crba,
    kinetic_energy,
    nonlinear_effects,
    potential_energy,
    rnea,
    rnea_derivatives,
)


@pytest.fixture(scope="module")
def model():
    return make_panda_model()


def _rand_state(seed):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.uniform(-1.5, 1.5, size=7))
    v = jnp.asarray(rng.uniform(-2.0, 2.0, size=7))
    a = jnp.asarray(rng.uniform(-5.0, 5.0, size=7))
    return q, v, a


def test_pendulum_closed_form():
    """Single revolute joint about y with a point mass at distance l along x:
    tau = m l^2 qddot - m g l cos(q)   (PE = -m g l sin q, g = -9.81 z)."""
    m_val, l = 2.0, 0.7
    model = RobotModel(
        joint_types=(REVOLUTE,),
        joint_names=("j1",),
        tree_rotation=np.eye(3)[None],
        tree_translation=np.zeros((1, 3)),
        axis=np.array([[0.0, 1.0, 0.0]]),
        mass=np.array([m_val]),
        com=np.array([[l, 0.0, 0.0]]),
        inertia=np.zeros((1, 3, 3)),
        gravity=np.array([0.0, 0.0, -9.81]),
        frames={},
    )
    for q0, v0, a0 in [(0.3, 0.5, 1.0), (-1.2, -2.0, 3.0), (0.0, 0.0, 0.0)]:
        tau = rnea(model, jnp.array([q0]), jnp.array([v0]), jnp.array([a0]))
        expected = m_val * l**2 * a0 - m_val * 9.81 * l * np.cos(q0)
        np.testing.assert_allclose(float(tau[0]), expected, rtol=1e-12, atol=1e-12)


def test_rnea_vs_lagrangian(model):
    """Newton-Euler torques must equal the Euler-Lagrange equations derived
    by autodiff of the (independent, FK-only) energy functions:
    tau = d/dt(dKE/dv) - dKE/dq + dPE/dq."""
    q, v, a = _rand_state(0)
    ke_v = jax.grad(kinetic_energy, argnums=2)
    H_vv = jax.jacfwd(ke_v, argnums=2)(model, q, v)
    H_vq = jax.jacfwd(ke_v, argnums=1)(model, q, v)
    dke_dq = jax.grad(kinetic_energy, argnums=1)(model, q, v)
    dpe_dq = jax.grad(potential_energy, argnums=1)(model, q)
    tau_lagrange = H_vv @ a + H_vq @ v - dke_dq + dpe_dq
    tau = rnea(model, q, v, a)
    np.testing.assert_allclose(tau, tau_lagrange, rtol=1e-9, atol=1e-9)


def test_crba_vs_energy_hessian(model):
    q, v, _ = _rand_state(1)
    M = crba(model, q)
    M_energy = jax.hessian(kinetic_energy, argnums=2)(model, q, v)
    np.testing.assert_allclose(M, M_energy, rtol=1e-9, atol=1e-10)
    # symmetric positive definite
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    assert np.all(np.linalg.eigvalsh(np.asarray(M)) > 0)


def test_rnea_linear_in_qddot(model):
    q, v, a = _rand_state(2)
    tau0 = rnea(model, q, v, jnp.zeros(7))
    M = crba(model, q)
    tau = rnea(model, q, v, a)
    np.testing.assert_allclose(tau, M @ a + tau0, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tau0, nonlinear_effects(model, q, v), atol=1e-12)


def test_rnea_derivatives_vs_finite_difference(model):
    q, v, a = _rand_state(3)
    dq, dv, da = rnea_derivatives(model, q, v, a)
    eps = 1e-6
    for k in range(7):
        e = jnp.zeros(7).at[k].set(eps)
        fd_q = (rnea(model, q + e, v, a) - rnea(model, q - e, v, a)) / (2 * eps)
        fd_v = (rnea(model, q, v + e, a) - rnea(model, q, v - e, a)) / (2 * eps)
        fd_a = (rnea(model, q, v, a + e) - rnea(model, q, v, a - e)) / (2 * eps)
        np.testing.assert_allclose(dq[:, k], fd_q, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(dv[:, k], fd_v, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(da[:, k], fd_a, rtol=2e-5, atol=2e-5)


def test_dtau_da_is_mass_matrix(model):
    q, v, a = _rand_state(4)
    _, _, da = rnea_derivatives(model, q, v, a)
    np.testing.assert_allclose(da, crba(model, q), rtol=1e-9, atol=1e-10)


def test_gravity_compensation_descent(model):
    """Reproduces the reference's dev experiment
    (test_develop/test_rnea_derivatives.cpp:63-82): gradient-descend qddot to
    minimize ||tau||^2 using dtau/da = M; torque norm must shrink toward the
    fixed point a* = -M^-1 nle."""
    q, v, _ = _rand_state(5)
    a = jnp.zeros(7)
    norm0 = float(jnp.linalg.norm(rnea(model, q, v, a)))
    # a few gradient steps must reduce the torque norm ...
    _, _, M = rnea_derivatives(model, q, v, a)
    step = 0.9 / float(np.linalg.eigvalsh(np.asarray(M.T @ M)).max())
    a_gd = a
    for _ in range(50):
        tau = rnea(model, q, v, a_gd)
        a_gd = a_gd - step * (M.T @ tau)
    assert float(jnp.linalg.norm(rnea(model, q, v, a_gd))) < 0.8 * norm0
    # ... and one Newton step with dtau/da solves it exactly (tau linear in a)
    a_newton = a - jnp.linalg.solve(M, rnea(model, q, v, a))
    assert float(jnp.linalg.norm(rnea(model, q, v, a_newton))) < 1e-8 * max(norm0, 1.0)


def test_rnea_batched_vmap(model):
    qs = jnp.stack([_rand_state(s)[0] for s in range(3)])
    vs = jnp.stack([_rand_state(s)[1] for s in range(3)])
    accs = jnp.stack([_rand_state(s)[2] for s in range(3)])
    taus = jax.jit(jax.vmap(lambda q, v, a: rnea(model, q, v, a)))(qs, vs, accs)
    for k in range(3):
        np.testing.assert_allclose(
            taus[k], rnea(model, qs[k], vs[k], accs[k]), rtol=1e-12
        )


def test_float32_accuracy(model):
    """The shipping path runs f32; torques must stay accurate to ~1e-4
    relative (torque scale is tens of Nm, tolerance budget is 1e-2)."""
    q, v, a = _rand_state(6)
    m32 = model.astype(jnp.float32)
    tau64 = rnea(model, q, v, a)
    tau32 = rnea(m32, q.astype(jnp.float32), v.astype(jnp.float32), a.astype(jnp.float32))
    np.testing.assert_allclose(tau32, tau64, rtol=2e-4, atol=2e-3)
