"""Multi-host (multi-controller) runtime: 2 real processes over one mesh.

The reference has no distributed backend at all (SURVEY §2.4) — this is
the scale-out path: jax.distributed coordination plus
collectives (psum for MSM partial combines, all_to_all for the four-step
NTT stage exchange), here driven cross-process on the CPU backend.

Each worker joins a 2-process cluster, builds the global mesh, and runs a
cross-process psum and all_to_all through shard_map — the exact collective
primitives parallel/sharded.py composes.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # two interpreter spawns + distributed setup

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[3])
import jax
from keyless_zk_tpu.parallel import distributed

ok = distributed.initialize(
    coordinator_address=f"127.0.0.1:{sys.argv[2]}", num_processes=2,
    process_id=int(sys.argv[1]),
)
assert ok, "distributed.initialize returned False"
assert jax.process_count() == 2

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map

mesh = distributed.global_mesh()
n = len(jax.devices())
assert n >= 2

# cross-process psum (the MSM partial-result combine)
x = jnp.arange(n, dtype=jnp.int32)
f = shard_map(lambda v: jax.lax.psum(v, "data"), mesh=mesh,
              in_specs=P("data"), out_specs=P())
y = jax.jit(f, out_shardings=NamedSharding(mesh, P()))(x)
got = int(np.asarray(y).ravel()[0])
assert got == n * (n - 1) // 2, (got, n)

# cross-process all_to_all (the four-step NTT stage exchange)
m = jnp.arange(n * n, dtype=jnp.int32).reshape(n, n)
g = shard_map(lambda v: jax.lax.all_to_all(v, "data", split_axis=1,
                                           concat_axis=0, tiled=True),
              mesh=mesh, in_specs=P("data", None), out_specs=P("data", None))
t = jax.jit(g, out_shardings=NamedSharding(mesh, P("data", None)))(m)
t.block_until_ready()
# per-device (1, n) blocks exchange to (n, 1) columns: device k ends up
# holding column k of m; globally t = m.T flattened to (n*n, 1). The
# result spans both processes, so check this process's shards only.
want = np.arange(n * n, dtype=np.int32).reshape(n, n).T.reshape(n * n, 1)
assert t.shape == (n * n, 1), t.shape
for shard in t.addressable_shards:
    assert np.array_equal(np.asarray(shard.data), want[shard.index]), \
        "all_to_all block exchange mismatch"

s, e = distributed.local_batch_slice(10)
assert (e - s) in (5,), (s, e)
print("WORKER_OK", jax.process_index(), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_collectives(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = str(_free_port())

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, repo],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        assert "WORKER_OK" in out
