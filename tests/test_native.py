"""Cross-language oracle: the C++ OTG must agree with the JAX OTG."""

import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.models.panda import make_panda_limits
from mpc_motion_planner_tpu.ops.otg import plan_trajectory

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("cmake") is None,
    reason="no native toolchain",
)


@pytest.fixture(scope="module")
def native():
    from mpc_motion_planner_tpu.utils import native as n

    n.load()
    return n


def test_native_matches_jax_random_problems(native):
    lim = make_panda_limits()
    vmax = np.asarray(0.8 * lim.max_velocity)
    amax = np.asarray(0.6 * lim.max_acceleration)
    jmax = np.asarray(0.1 * lim.max_jerk)
    for seed in range(20):
        rng = np.random.default_rng(seed)
        p0 = rng.uniform(-2, 2, 7)
        pf = rng.uniform(-2, 2, 7)
        v0 = rng.uniform(-1, 1, 7) * vmax
        vf = rng.uniform(-1, 1, 7) * vmax

        dur, dt_n, jk_n = native.plan_trajectory_native(
            p0, v0, pf, vf, vmax, amax, jmax
        )
        traj = plan_trajectory(
            *(jnp.asarray(a) for a in (p0, v0, pf, vf, vmax, amax, jmax))
        )
        assert dur == pytest.approx(float(traj.duration), abs=1e-8)

        ts = np.linspace(0, dur, 101)
        p_n, v_n, a_n = native.sample_native(
            ts, dur, p0, v0, dt_n, jk_n
        )
        p_j, v_j, a_j = jax.vmap(traj.at_time)(jnp.asarray(ts))
        np.testing.assert_allclose(p_n, np.asarray(p_j), atol=1e-6)
        np.testing.assert_allclose(v_n, np.asarray(v_j), atol=1e-6)
        np.testing.assert_allclose(a_n, np.asarray(a_j), atol=1e-5)


def test_native_end_state(native):
    rng = np.random.default_rng(42)
    p0 = rng.uniform(-1, 1, 7)
    pf = rng.uniform(-1, 1, 7)
    v0 = np.zeros(7)
    vf = np.zeros(7)
    lim = make_panda_limits()
    dur, dt_n, jk_n = native.plan_trajectory_native(
        p0, v0, pf, vf,
        np.asarray(lim.max_velocity),
        np.asarray(lim.max_acceleration),
        np.asarray(0.1 * lim.max_jerk),
    )
    p, v, a = native.sample_native(np.asarray([dur]), dur, p0, v0, dt_n, jk_n)
    np.testing.assert_allclose(p[0], pf, atol=1e-8)
    np.testing.assert_allclose(v[0], 0, atol=1e-9)
    np.testing.assert_allclose(a[0], 0, atol=1e-9)


def _native_copy(tmp_path, monkeypatch):
    """A copy of native/ in tmp_path, with utils.native pointed at it and
    a stale placeholder library in its build directory."""
    from mpc_motion_planner_tpu.utils import native as n

    src = pathlib.Path(n._NATIVE_DIR)
    dst = tmp_path / "native"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(n, "_NATIVE_DIR", str(dst))
    lib = dst / "build" / n._LIB_NAME
    lib.parent.mkdir()
    lib.write_bytes(b"stale")
    return n, dst / "otg.cpp", lib


def test_native_rebuilds_when_source_is_newer(tmp_path, monkeypatch):
    n, src, lib = _native_copy(tmp_path, monkeypatch)
    os.utime(lib, (1_000_000, 1_000_000))  # library older than otg.cpp
    assert n._build() == str(lib)
    assert lib.read_bytes() != b"stale"
    assert lib.stat().st_mtime >= src.stat().st_mtime


def test_native_keeps_library_built_from_current_source(tmp_path, monkeypatch):
    n, src, lib = _native_copy(tmp_path, monkeypatch)
    os.utime(src, (1_000_000, 1_000_000))  # source older than the library
    assert n._build() == str(lib)
    assert lib.read_bytes() == b"stale"
