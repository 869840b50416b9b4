"""Platform decision and process set-up shared by every entry point.

`bench.py`, `examples/*.py`, the acceptance benchmark and `chip_smoke.py`
all resolve the QP backend through :func:`qp_backend` and prepare the
process through :func:`setup`, so the documented no-flag commands run the
same configuration on a given platform.
"""

from __future__ import annotations

import functools
import os

# Fixed in-checkout location of JAX's persistent compilation cache, used
# when JAX_COMPILATION_CACHE_DIR is not set. The path is part of the cache
# key, so it is never built from a temp name, a pid or a time.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

PLATFORMS = ("gpu", "cpu")


def qp_backend(platform: str) -> str:
    """QP backend for a ``jax.default_backend()`` string.

    The matrix-free ``structured`` backend (ops/qp_structured.py) on the
    GPU and the CPU; any other platform raises."""
    if platform in PLATFORMS:
        return "structured"
    raise ValueError(
        f"unsupported platform {platform!r}: the planner runs on "
        f"{' or '.join(PLATFORMS)}"
    )


def shipping_qp_settings(platform: str, **overrides):
    """The shipping QP settings for `platform`: the backend of
    :func:`qp_backend`, fixed rho (adaptive rho was measured to hurt on
    this workload, KERNELS.md) and no iterative refinement (the factored
    structured solve is backward-stable). Everything else keeps the
    reference budget of QPSettings: <=700 iterations at eps 1e-3."""
    from .ops.qp import QPSettings

    kw = dict(backend=qp_backend(platform), kkt_refine=0, rho_update_every=0)
    kw.update(overrides)
    return QPSettings(**kw)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is set in code. Otherwise the cache goes to DEFAULT_CACHE_DIR.
    Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def setup(platform: str | None = None, x64: bool = False) -> str:
    """Prepare the process before its first device use: pin the platform
    (``gpu`` or ``cpu``; None keeps JAX's default), optionally enable
    float64, and set up the compile cache. Returns the platform JAX
    reports, after checking it with :func:`qp_backend`."""
    import jax

    if platform is not None:
        qp_backend(platform)
        jax.config.update("jax_platforms", "cuda" if platform == "gpu" else platform)
    if x64:
        jax.config.update("jax_enable_x64", True)
    setup_compile_cache()
    observed = jax.default_backend()
    qp_backend(observed)
    return observed


def full_precision(fn):
    """Run ``fn`` with every float32 matrix product at full precision.

    On the GPU a float32 dot at default precision may run in TF32 (about
    three decimal digits), which moves the terminal-error figures that
    decide tol_hit against a 1e-2 box. The public solve, sampling and
    re-simulation entry points carry this decorator; it applies while the
    function is traced, so everything it calls inherits it."""
    import jax

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
