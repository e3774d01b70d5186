"""Multi-host (multi-controller) runtime setup for the proving mesh.

The reference is a single-node shared-memory system (SURVEY §2.4: no
NCCL/MPI analog); the scaling path here is jax.distributed: one
controller process per host, all devices joined into one global mesh, with
collectives inside `shard_map` (parallel/sharded.py) and request sharding
across hosts for the batched prover (BASELINE configs[4]).

Usage (one process per host):

    from keyless_zk_tpu.parallel import distributed
    distributed.initialize()          # env-driven or explicit
    mesh = distributed.global_mesh()  # all devices across all hosts

    # data-parallel batched proving: each host feeds its local batch slice
    with mesh:
        ...

Pass coordinator_address/num_processes/process_id (or set
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID): nothing in
the environment announces a cluster.

Single-host fallback: initialize() is a no-op when no coordination is
configured, so every code path works unchanged on one host (this is how the
CPU test mesh exercises the same code).
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the multi-controller runtime. Returns True if distributed mode
    is active, False for the single-process fallback."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes or _env_int("JAX_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("JAX_PROCESS_ID")

    if coordinator_address is None:
        return False  # single-process mode
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def global_mesh(axis: str = "data") -> "jax.sharding.Mesh":
    """A 1-D mesh over every device of every joined process."""
    from jax.sharding import Mesh

    return Mesh(jax.devices(), (axis,))


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """[start, end) of this host's slice of a globally-sharded batch."""
    n = jax.process_count()
    i = jax.process_index()
    per = -(-global_batch // n)
    return min(i * per, global_batch), min((i + 1) * per, global_batch)
