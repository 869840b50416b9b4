"""Device-mesh scale-out for batched solves.

The workload's one real parallel axis is the scenario batch (SURVEY.md
§2.3): thousands of independent (start, goal) solves. Scaling is therefore
pure data parallelism over a 1-D mesh — states are sharded over the
``batch`` axis, the whole solve partitions cleanly under GSPMD (every op is
batched elementwise over trajectories apart from cheap scalar reductions in
the solver loops), and cross-device communication is limited to the
benchmark metric reductions (psum of violation counts / residual stats).
The mesh is 1-D: the cards of one host are joined all to all by NVLink, so
its shape follows the algorithm alone.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def initialize_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
):
    """Join an N-host data-parallel job: `jax.distributed` wiring.

    Call BEFORE any other JAX device use (the coordination service and the
    device topology are fixed at backend initialization). After it returns,
    ``jax.devices()`` is the GLOBAL device list across all processes and
    :func:`make_mesh` builds the global batch mesh; every process runs the
    same program SPMD over its local shard (scale-out semantics per
    SURVEY.md §2.3 — the only cross-host communication is the psum-style
    metric reductions, which XLA lowers onto cross-process collectives).

    This is a CPU test helper (SURVEY.md §4): pass ``local_device_count``
    to give every process that many virtual host devices; cross-process
    CPU collectives use the gloo backend.
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}"
        )
        # virtual host devices imply the CPU platform; gloo is the only
        # cross-process CPU collective implementation
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_batch_multihost(mesh: Mesh, tree, axis_name: str = BATCH_AXIS):
    """Assemble global batch-sharded arrays from PER-PROCESS local data.

    Every process passes its local (B_local, ...) slice; the returned
    arrays are global jax.Arrays of shape (num_processes * B_local, ...)
    sharded over `axis_name`, ready for the jitted solve fns below.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, np.asarray(a)
        ),
        tree,
    )


def make_mesh(devices=None, axis_name: str = BATCH_AXIS) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(mesh: Mesh, tree, axis_name: str = BATCH_AXIS):
    """Place a pytree of (B, ...) arrays with the batch dim sharded."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def sharded_solve_fn(planner, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """A jitted solve over the mesh: states sharded on `axis_name`, solver
    state partitioned by GSPMD, plus psum-style aggregate stats.

    Returns fn(current, target) -> (Solution, stats dict with batch-global
    reductions).
    """
    sharding = NamedSharding(mesh, P(axis_name))

    def step(current, target):
        sol = planner.solve(current, target)
        stats = {
            "mean_violation": jnp.mean(sol.violation),
            "max_violation": jnp.max(sol.violation),
            "mean_qp_iterations": jnp.mean(sol.qp_iterations.astype(jnp.float32)),
            "num_converged": jnp.sum(jnp.all(sol.qp_converged, axis=-1)),
        }
        return sol, stats

    return jax.jit(step, in_shardings=(sharding, sharding))


def shard_map_solve_fn(planner, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Per-shard dispatch of the FULL solve: every device runs the
    complete planner solve on its local batch shard (the workload is pure
    data parallelism — zero intra-solve communication), and the aggregate
    stats are batch-global reductions computed on the sharded outputs
    outside the shard_map (XLA inserts the collectives, which run over
    NVLink between the cards of one host).

    The batch must divide evenly by the mesh size (callers pad).

    Returns fn(current, target) -> (Solution, stats dict), jitted.
    """

    def local_solve(current, target):
        sol = planner.solve(current, target)
        # return only the batched leaves: Solution carries the (static,
        # unbatched) TranscribedOCP, which must not be sharded on batch
        return dict(
            z=sol.z, lam_c=sol.lam_c, lam_x=sol.lam_x,
            violation=sol.violation, qp_iterations=sol.qp_iterations,
            qp_converged=sol.qp_converged, step_sizes=sol.step_sizes,
            warm_start=sol.warm_start,
        )

    sharded = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
        # the solve is independent per problem; no collectives inside
        check_vma=False,
    )

    def step(current, target):
        from ..planner import Solution

        sol = Solution(ocp=planner.ocp, **sharded(current, target))
        stats = {
            "mean_violation": jnp.mean(sol.violation),
            "max_violation": jnp.max(sol.violation),
            "mean_qp_iterations": jnp.mean(sol.qp_iterations.astype(jnp.float32)),
            "num_converged": jnp.sum(jnp.all(sol.qp_converged, axis=-1)),
        }
        return sol, stats

    return jax.jit(step)
