"""Multi-host (multi-process) sharded-codec test via jax.distributed.

Two coordinated CPU processes, 4 virtual devices each, form one 8-device
global mesh; each process drives its half of a shard_map'd batch
compression and checks its addressable archives byte-for-byte against the
NumPy oracle. This covers the cross-host path the reference never had
(SURVEY.md §4 implication c)."""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_WORKER = r"""
import os
import sys

# two CPU processes, never the card
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(f"localhost:{port}", num_processes=2,
                           process_id=pid)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dietgpu_fork_tpu.core import reference as R
from dietgpu_fork_tpu.core.constants import FloatType
from dietgpu_fork_tpu.parallel import sharded as sh

devs = jax.devices()
assert len(devs) == 8, f"expected 8 global devices, got {len(devs)}"
mesh = Mesh(np.array(devs), ("data",))
B, n = 8, 4096
rng = np.random.default_rng(3)
w = (rng.normal(0, 1, (B, n)).astype(np.float32).view(np.uint32) >> 16
     ).astype(np.uint16)
data_np = np.ascontiguousarray(w).view(np.uint32).reshape(B, -1)
sizes_np = np.full((B,), n, np.int32)

sharding = NamedSharding(mesh, P("data"))


def gshard(arr):
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: jnp.asarray(arr[idx])
    )


data32 = gshard(data_np)
sizes = gshard(sizes_np)

comp, comp_bytes = sh.float_compress_sharded(
    mesh, data32, sizes, FloatType.BFLOAT16
)

# per-process check: my addressable archive rows == oracle bytes
for shard in comp.addressable_shards:
    rows = range(*shard.index[0].indices(B))
    local = np.asarray(shard.data).view(np.uint8)
    for j, b in enumerate(rows):
        want = R.float_compress(w[b], FloatType.BFLOAT16)
        got = local[j, : want.size]
        assert np.array_equal(got, np.frombuffer(want, np.uint8)), (
            f"process {pid} member {b}: archive mismatch"
        )

# cross-host collective: global compressed sizes visible on every process
allsz = np.asarray(sh.global_compressed_sizes(comp_bytes, mesh))
assert allsz.shape == (B,)
for b in range(B):
    want = R.float_compress(w[b], FloatType.BFLOAT16)
    assert allsz[b] == want.size

# decompress across the mesh and verify local shards
out32, success, nsz, _, _ = sh.float_decompress_sharded(
    mesh, comp, n, FloatType.BFLOAT16
)
for shard in out32.addressable_shards:
    rows = range(*shard.index[0].indices(B))
    local = np.asarray(shard.data).view(np.uint8)
    for j, b in enumerate(rows):
        assert np.array_equal(local[j, : 2 * n], w[b].view(np.uint8))

print(f"process {pid} ok", flush=True)
"""


def test_two_process_sharded_codec(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PYTHONWARNINGS", None)
    port = "12757"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"process {pid} ok" in out
