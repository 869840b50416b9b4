"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device sharding is validated on host CPU devices; numerics tests use
x64 so closed-form oracles are tight. The shipping path runs float32 —
precision-sensitive tests therefore also include f32-tolerance variants
where it matters. Tests that need a GPU carry the `gpu` marker and take
the `gpu_devices` fixture, which skips them here.
"""

import os

# CPU unless the caller names the platforms, as the GPU tier does:
#     JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_devices():
    """JAX's GPUs; skips the test when there are none. Tests that take it
    carry the `gpu` marker."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX reports {devices[0].platform!r}")
    return devices


# ---------------------------------------------------------------------------
# Two-tier suite: the tests below are dominated by multi-minute CPU compiles
# of full solves. They are auto-marked `slow` here — centrally, so the tier
# split can be re-tuned from one list — and deselected by the default
# `pytest -q` tier (addopts in pyproject.toml). The FULL suite stays the
# acceptance gate:
#     python -m pytest tests/ -q -m ""
_SLOW = {
    ("test_qp_structured", "test_planner_solve_structured_matches_xla"),
    ("test_qp_structured", "test_structured_backend_matches_xla_on_planner_qps"),
    ("test_parallel", "test_shard_map_structured_backend_matches_single_device"),
    ("test_parallel", "test_multihost_two_process_mesh"),
    ("test_parallel", "test_graft_dryrun_multichip"),
    ("test_parallel", "test_graft_entry_compiles"),
    ("test_parallel", "test_sharded_solve_matches_single_device"),
    ("test_parallel", "test_sharded_structured_backend_matches_single_device"),
    ("test_profiling", "test_stage_timings_structured_smoke"),
    ("test_profiling", "test_stage_timings_smoke"),
    ("test_qp", "test_sqp_accepts_problem_delegated_hessian"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if (item.module.__name__, base) in _SLOW:
            item.add_marker(pytest.mark.slow)


# Full-suite stability: one pytest process accumulates every compiled XLA
# executable (the suite jit-compiles hundreds of distinct solver
# configurations, several with very large HLO graphs). By test ~113/135 the process RSS passes ~5 GB and the
# NEXT big CPU compile segfaults inside XLA's compiler
# (jax/_src/compiler.py backend_compile_and_load) — reproducible on this
# image, and every chunk passes in isolation. Dropping the caches at module
# boundaries releases the executables of finished modules (no test reuses
# jitted functions across modules), which keeps peak RSS bounded and the
# one-invocation run green. Cost: a handful of recompiles for
# session-scoped helpers, ~1 min on the full suite.
@pytest.fixture(scope="module", autouse=True)
def _bound_xla_cache_growth():
    yield
    jax.clear_caches()
