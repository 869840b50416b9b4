"""Batched jerk-limited time-optimal online trajectory generation (OTG).

Batched replacement for the used slice of Ruckig (the reference's
mpc_solver/motionPlanner.hpp:35-37, motionPlanner.cpp:146-175): per-joint
time-optimal third-order (jerk-limited) point-to-point profiles with
velocity/acceleration/jerk bounds, nonzero boundary velocities and
accelerations (the reference API plumbs current/target acceleration into
Ruckig's InputParameter, motionPlanner.cpp:27-54, though its examples only
exercise the zero case), time-synchronized across joints, and evaluable at
arbitrary times.

Nonzero boundary accelerations are handled by reduction: a prologue jerk
phase takes (v0, a0) to zero acceleration and an epilogue jerk phase (built
in reverse time) takes zero acceleration to (vf, af); the time-optimal
zero-acceleration core runs between them. The resulting profile satisfies
the boundary conditions exactly and all limits, but is not guaranteed
time-optimal when a boundary acceleration is nonzero (Ruckig's exhaustive
profile-type enumeration is); for the planner's warm-start role validity
and synchronization are what matter.

Design (everything closed-form + fixed-iteration bisection, so it vmaps and
jits with static shapes):

* A velocity ramp va -> vb under (amax, jmax) is the classic S-ramp: two
  jerk phases around an optional constant-acceleration phase. Its duration
  is ``|dv|/amax + amax/jmax`` (trapezoidal) or ``2 sqrt(|dv|/jmax)``
  (triangular); because the acceleration profile is time-symmetric the ramp
  distance is exactly ``(va+vb)/2 * T``.
* A full profile is ramp(v0 -> vp), cruise at vp, ramp(vp -> vf). The
  no-cruise displacement D(vp) is non-decreasing in vp, so the time-optimal
  cruise velocity is +-vmax when a cruise phase fits, otherwise the root of
  D(vp) = dp found by bisection.
* Synchronization: T = max over joints of the per-joint minimal time; each
  joint is re-solved for duration exactly T by bisecting vp on
  [min(0, vp*), max(0, vp*)] of the fixed-time displacement
  D_T(vp) = D(vp) + vp * (T - T_ramps(vp)), which is increasing in vp
  (the vp -> 0 limit degenerates to a dwell, so any T >= T* is reachable).
* ``at_time`` composes the seven phases with per-phase clipped dt, which is
  exact and branch-free.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class JerkLimitedTrajectory:
    """Synchronized multi-joint jerk-limited trajectory (a pytree).

    All leaves share leading batch dims; the last axis is joints for the
    state arrays and (joints, n_phases) for the phase tables (7 phases for
    zero boundary accelerations, 9 with the prologue/epilogue jerk phases).
    """

    duration: jax.Array  # (...,) synchronized total duration
    start_position: jax.Array  # (..., nj)
    start_velocity: jax.Array  # (..., nj)
    start_acceleration: jax.Array  # (..., nj)
    phase_dt: jax.Array  # (..., nj, n_phases) phase durations (>= 0)
    phase_jerk: jax.Array  # (..., nj, n_phases) constant jerk per phase

    def at_time(self, t):
        """Sample (position, velocity, acceleration) at time(s) ``t``.

        ``t`` broadcasts against the batch shape; times beyond the duration
        clamp to the final state (reference semantics, motionPlanner.hpp:132).
        """
        t = jnp.minimum(jnp.asarray(t, self.duration.dtype), self.duration)
        p = self.start_position
        v = self.start_velocity
        a = self.start_acceleration
        remaining = t[..., None]  # broadcast over joints
        for k in range(self.phase_dt.shape[-1]):
            dt = jnp.clip(remaining, 0.0, self.phase_dt[..., k])
            j = self.phase_jerk[..., k]
            p = p + v * dt + 0.5 * a * dt**2 + j * dt**3 / 6.0
            v = v + a * dt + 0.5 * j * dt**2
            a = a + j * dt
            remaining = remaining - self.phase_dt[..., k]
        return p, v, a


def _ramp(va, vb, amax, jmax):
    """S-ramp va -> vb: (t_jerk, t_const_accel, total_time, distance)."""
    dv = jnp.abs(vb - va)
    trapezoid = dv >= amax**2 / jmax
    tj = jnp.where(trapezoid, amax / jmax, jnp.sqrt(dv / jmax))
    ta = jnp.where(trapezoid, dv / amax - amax / jmax, 0.0)
    total = 2.0 * tj + ta
    dist = 0.5 * (va + vb) * total
    return tj, ta, total, dist


def _ramps_time_dist(v0, vp, vf, amax, jmax):
    *_, t1, d1 = _ramp(v0, vp, amax, jmax)
    *_, t3, d3 = _ramp(vp, vf, amax, jmax)
    return t1 + t3, d1 + d3


def _min_time_cruise_velocity(dp, v0, vf, vmax, amax, jmax, iters):
    """Time-optimal cruise velocity and cruise duration for one joint."""
    t_hi, d_hi = _ramps_time_dist(v0, vmax, vf, amax, jmax)
    t_lo, d_lo = _ramps_time_dist(v0, -vmax, vf, amax, jmax)
    tb_hi = (dp - d_hi) / vmax
    tb_lo = (dp - d_lo) / (-vmax)
    use_hi = tb_hi >= 0.0
    use_lo = jnp.logical_and(jnp.logical_not(use_hi), tb_lo >= 0.0)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        _, d_mid = _ramps_time_dist(v0, mid, vf, amax, jmax)
        go_up = d_mid < dp
        return jnp.where(go_up, mid, lo), jnp.where(go_up, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, iters, body, (-vmax * jnp.ones_like(dp), vmax * jnp.ones_like(dp))
    )
    vp_bisect = 0.5 * (lo + hi)

    vp = jnp.where(use_hi, vmax, jnp.where(use_lo, -vmax, vp_bisect))
    tb = jnp.where(use_hi, tb_hi, jnp.where(use_lo, tb_lo, 0.0))
    t_ramps, _ = _ramps_time_dist(v0, vp, vf, amax, jmax)
    return vp, tb, t_ramps + tb


def _cruise_velocity_for_duration(dp, v0, vf, vmax, duration, amax, jmax, iters):
    """Re-solve vp so the profile lasts exactly `duration` (>= min time).

    Bisects the CLAMPED fixed-time displacement
        D_T(vp) = d_ramps(vp) + vp * max(duration - t_ramps(vp), 0)
    over the full [-vmax, vmax]: with the cruise time clamped at zero both
    pieces are non-decreasing in vp (ramp-only displacement is, and the
    cruise term only adds |vp|-weighted time), the function is continuous
    at the clamp boundary, and for duration >= per-joint minimal time a
    root with nonnegative cruise always exists — including the cases where
    the cruise velocity must flip sign against the boundary velocities
    (e.g. v0 = vf < 0 with a small negative displacement needs vp > 0)."""

    def d_fixed_time(vp):
        t_ramps, d = _ramps_time_dist(v0, vp, vf, amax, jmax)
        return d + vp * jnp.maximum(duration - t_ramps, 0.0)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        go_up = d_fixed_time(mid) < dp
        return jnp.where(go_up, mid, lo), jnp.where(go_up, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (-vmax, vmax))
    vp = 0.5 * (lo + hi)
    t_ramps, _ = _ramps_time_dist(v0, vp, vf, amax, jmax)
    tb = jnp.maximum(duration - t_ramps, 0.0)
    return vp, tb


def _build_phases(v0, vp, vf, tb, amax, jmax):
    """Phase tables (dt, jerk) each (..., 7) for ramp/cruise/ramp."""
    s1 = jnp.sign(vp - v0)
    s3 = jnp.sign(vf - vp)
    tj1, ta1, _, _ = _ramp(v0, vp, amax, jmax)
    tj3, ta3, _, _ = _ramp(vp, vf, amax, jmax)
    zeros = jnp.zeros_like(tb)
    phase_dt = jnp.stack([tj1, ta1, tj1, tb, tj3, ta3, tj3], axis=-1)
    phase_jerk = jnp.stack(
        [s1 * jmax, zeros, -s1 * jmax, zeros, s3 * jmax, zeros, -s3 * jmax],
        axis=-1,
    )
    return phase_dt, phase_jerk


def plan_trajectory(
    start_position,
    start_velocity,
    target_position,
    target_velocity,
    max_velocity,
    max_acceleration,
    max_jerk,
    bisect_iters: int = 64,
    start_acceleration=None,
    target_acceleration=None,
) -> JerkLimitedTrajectory:
    """Time-optimal synchronized trajectory (``Ruckig<7>::calculate``).

    All state arrays are (..., nj); limit arrays broadcast against them.
    Boundary accelerations default to zero (the case the reference's
    examples use); nonzero values are honored exactly via prologue/epilogue
    jerk phases (see the module docstring) as the reference API allows
    (InputParameter current/target acceleration, motionPlanner.cpp:27-54).
    """
    dp = target_position - start_position
    v0, vf = start_velocity, target_velocity
    vmax = jnp.broadcast_to(max_velocity, dp.shape).astype(dp.dtype)
    amax = jnp.broadcast_to(max_acceleration, dp.shape).astype(dp.dtype)
    jmax = jnp.broadcast_to(max_jerk, dp.shape).astype(dp.dtype)

    with_acc = start_acceleration is not None or target_acceleration is not None
    a0 = (
        jnp.zeros_like(v0)
        if start_acceleration is None
        else jnp.broadcast_to(start_acceleration, dp.shape).astype(dp.dtype)
    )
    af = (
        jnp.zeros_like(vf)
        if target_acceleration is None
        else jnp.broadcast_to(target_acceleration, dp.shape).astype(dp.dtype)
    )

    # ---- prologue: jerk a0 -> 0; epilogue (reverse time): jerk 0 -> af ----
    t_pre = jnp.abs(a0) / jmax
    j_pre = -jnp.sign(a0) * jmax
    dv_pre = a0 * t_pre + 0.5 * j_pre * t_pre**2  # = sign(a0) a0^2 / (2 jmax)
    dp_pre = v0 * t_pre + 0.5 * a0 * t_pre**2 + j_pre * t_pre**3 / 6.0
    v0i = v0 + dv_pre

    t_post = jnp.abs(af) / jmax
    j_post = jnp.sign(af) * jmax
    dv_post = 0.5 * j_post * t_post**2  # velocity gained while building af
    vfi = vf - dv_post
    dp_post = vfi * t_post + j_post * t_post**3 / 6.0

    dpi = dp - dp_pre - dp_post

    _, _, t_min = _min_time_cruise_velocity(
        dpi, v0i, vfi, vmax, amax, jmax, bisect_iters
    )
    duration = jnp.max(t_min + t_pre + t_post, axis=-1)

    inner_T = duration[..., None] - t_pre - t_post
    vp, tb = _cruise_velocity_for_duration(
        dpi, v0i, vfi, vmax, inner_T, amax, jmax, bisect_iters
    )
    phase_dt, phase_jerk = _build_phases(v0i, vp, vfi, tb, amax, jmax)
    if with_acc:
        phase_dt = jnp.concatenate(
            [t_pre[..., None], phase_dt, t_post[..., None]], axis=-1
        )
        phase_jerk = jnp.concatenate(
            [j_pre[..., None], phase_jerk, j_post[..., None]], axis=-1
        )
    return JerkLimitedTrajectory(
        duration=duration,
        start_position=start_position,
        start_velocity=start_velocity,
        start_acceleration=a0,
        phase_dt=phase_dt,
        phase_jerk=phase_jerk,
    )
