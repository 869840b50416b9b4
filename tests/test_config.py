"""The platform decision, the compile-cache set-up and the precision
contract of the public entry points (mpc_motion_planner_tpu/config.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu import config
from mpc_motion_planner_tpu.bench.harness import benchmark_records
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner, Solution


@pytest.mark.parametrize(
    "platform, expected",
    [("gpu", "structured"), ("cpu", "structured"), ("metal", None)],
)
def test_qp_backend_per_platform(platform, expected):
    if expected is None:
        with pytest.raises(ValueError, match="unsupported platform"):
            config.qp_backend(platform)
    else:
        assert config.qp_backend(platform) == expected


def test_shipping_qp_settings():
    s = config.shipping_qp_settings("cpu", max_iter=50)
    assert (s.backend, s.kkt_refine, s.rho_update_every) == ("structured", 0, 0)
    assert s.max_iter == 50
    with pytest.raises(ValueError):
        config.shipping_qp_settings("metal")


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.setup_compile_cache() == str(tmp_path)
    # nothing is set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.setup_compile_cache()
    assert path == config.DEFAULT_CACHE_DIR
    assert path == str(config.REPO_ROOT) + "/.jax_cache"
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every call: never a temp name, pid or time
    assert config.setup_compile_cache() == path


def _dot_precisions(lowered_text):
    lines = [l for l in lowered_text.splitlines() if "stablehlo.dot_general" in l]
    return lines, [l for l in lines if "precision = [HIGHEST, HIGHEST]" not in l]


@pytest.fixture(scope="module")
def f32_planner():
    return MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        qp_settings=config.shipping_qp_settings("cpu"),
        dtype=jnp.float32,
    )


@pytest.mark.parametrize("entry", ["solve", "sample", "benchmark_records"])
def test_public_entry_points_lower_every_dot_at_highest(f32_planner, entry):
    """On the GPU a float32 dot at default precision may run in TF32;
    every dot_general the public solve, sampling and re-simulation entry
    points lower must ask for HIGHEST."""
    p = f32_planner
    cur = jnp.zeros((2, 14), jnp.float32)
    tgt = jnp.full((2, 14), 0.1, jnp.float32)
    if entry == "solve":
        fn, args = (lambda c, t: p.solve(c, t).z), (cur, tgt)
    elif entry == "sample":
        def fn(z):
            sol = Solution(
                ocp=p.ocp, z=z, lam_c=None, lam_x=None, violation=None,
                qp_iterations=None, qp_converged=None, step_sizes=None,
                warm_start=None,
            )
            return sol.sample(200)

        args = (jnp.ones((2, p.ocp.num_var), jnp.float32),)
    else:
        def fn(c, t):
            return benchmark_records(p, p.solve(c, t), t)[0]

        args = (cur, tgt)
    dots, not_highest = _dot_precisions(jax.jit(fn).lower(*args).as_text())
    assert dots, "expected matrix products in the lowered program"
    assert not not_highest, not_highest[:3]


def test_default_precision_is_not_highest_without_the_decorator():
    """The check above is not vacuous: a bare einsum lowers at DEFAULT."""
    text = jax.jit(
        lambda a, b: jnp.einsum("ij,jk->ik", a, b)
    ).lower(np.ones((3, 3), np.float32), np.ones((3, 3), np.float32)).as_text()
    dots, not_highest = _dot_precisions(text)
    assert dots and not_highest
