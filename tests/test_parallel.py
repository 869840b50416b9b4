import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_motion_planner_tpu.ops.qp import QPSettings
from mpc_motion_planner_tpu.ops.sqp import SQPSettings
from mpc_motion_planner_tpu.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_map_solve_fn,
    sharded_solve_fn,
)
from mpc_motion_planner_tpu.planner import Margins, MotionPlanner

FAST = dict(
    sqp_settings=SQPSettings(max_iter=1),
    qp_settings=QPSettings(max_iter=50, check_every=10, rho_update_every=0),
)


@pytest.fixture(scope="module")
def planner():
    return MotionPlanner(margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1), **FAST)


def _states(planner, batch):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    q0, v0 = planner.sample_random_state(k1, (batch,))
    q1, v1 = planner.sample_random_state(k2, (batch,))
    return jnp.concatenate([q0, v0], -1), jnp.concatenate([q1, v1], -1)


def test_eight_device_mesh_available():
    assert len(jax.devices()) >= 8  # conftest forces 8 host CPU devices


def test_sharded_solve_matches_single_device(planner):
    cur, tgt = _states(planner, 8)
    sol_ref = planner.solve(cur, tgt)

    mesh = make_mesh(jax.devices()[:4])
    cur_s, tgt_s = shard_batch(mesh, (cur, tgt))
    step = sharded_solve_fn(planner, mesh)
    sol, stats = step(cur_s, tgt_s)
    np.testing.assert_allclose(np.asarray(sol.z), np.asarray(sol_ref.z), atol=2e-8)
    assert float(stats["mean_violation"]) == pytest.approx(
        float(jnp.mean(sol_ref.violation)), rel=1e-6
    )


def test_sharded_structured_backend_matches_single_device():
    """The PRODUCTION backend (matrix-free structured ADMM) partitions
    under GSPMD over the batch mesh and reproduces single-device results —
    the dense XLA path is not the only one that runs sharded."""
    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        sqp_settings=SQPSettings(max_iter=1),
        qp_settings=QPSettings(
            max_iter=50, check_every=10, rho_update_every=0,
            backend="structured", kkt_refine=1,
        ),
    )
    cur, tgt = _states(planner, 8)
    sol_ref = planner.solve(cur, tgt)

    mesh = make_mesh(jax.devices()[:4])
    cur_s, tgt_s = shard_batch(mesh, (cur, tgt))
    step = sharded_solve_fn(planner, mesh)
    sol, stats = step(cur_s, tgt_s)
    np.testing.assert_allclose(np.asarray(sol.z), np.asarray(sol_ref.z), atol=2e-8)
    assert float(stats["max_violation"]) == pytest.approx(
        float(jnp.max(sol_ref.violation)), rel=1e-6
    )


def test_shard_map_structured_backend_matches_single_device():
    """shard_map dispatches the whole shipping (structured) solve per
    shard; sharded results must match the single-device run."""
    planner = MotionPlanner(
        margins=Margins(0.8, 0.8, 0.6, 0.9, 0.1),
        sqp_settings=SQPSettings(max_iter=1),
        qp_settings=QPSettings(
            max_iter=50, check_every=10, rho_update_every=0,
            backend="structured",
        ),
    )
    cur, tgt = _states(planner, 8)
    # The reference must be JITTED: eager execution compiles the ops
    # one-by-one while jit lets XLA fuse/FMA-contract them, perturbing
    # iterates at the ulp level, which 50 mid-flight ADMM iterations
    # amplify.
    sol_ref_z = jax.jit(lambda c, t: planner.solve(c, t).z)(cur, tgt)
    sol_ref_viol = jax.jit(lambda c, t: planner.solve(c, t).violation)(cur, tgt)

    mesh = make_mesh(jax.devices()[:4])
    cur_s, tgt_s = shard_batch(mesh, (cur, tgt))
    step = shard_map_solve_fn(planner, mesh)
    sol, stats = step(cur_s, tgt_s)
    # per-problem solves are independent of the batch grouping
    np.testing.assert_allclose(
        np.asarray(sol.z), np.asarray(sol_ref_z), atol=1e-6
    )
    assert float(stats["max_violation"]) == pytest.approx(
        float(jnp.max(sol_ref_viol)), rel=1e-5
    )
    # outputs really are laid out over the mesh
    assert len(sol.z.addressable_shards) == 4


def test_sharding_actually_partitions(planner):
    mesh = make_mesh(jax.devices()[:4])
    cur, tgt = _states(planner, 8)
    cur_s, _ = shard_batch(mesh, (cur, tgt))
    # each of the 4 devices holds a (2, 14) shard
    shards = cur_s.addressable_shards
    assert len(shards) == 4
    assert all(s.data.shape == (2, 14) for s in shards)


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(4)


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    assert compiled is not None


def test_multihost_two_process_mesh():
    """N>=2 host processes (SURVEY §2.3 / BASELINE north star): two
    jax.distributed CPU processes with 2 virtual devices each form a
    global 4-device mesh; the sharded solve + psum'd stats must match a
    locally computed all-batch reference in each process (see
    tests/multihost_worker.py)."""
    import os
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, "localhost:12921", "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid}" in out
