"""2-process CPU smoke of the multi-host scaffold.

Spawns two OS processes, each with two virtual CPU devices, joined by
``jax.distributed`` into one 4-device global mesh (db axis spanning the
process boundary, as it spans hosts in a deployment).  Each runs the sharded PIR pipeline
on a tiny database; the fully-replicated reply decodes to the requested
item in both processes.  (BASELINE "N>=2 hosts" rung; SURVEY §5h.)
"""

import os
import socket
import subprocess
import sys
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, "@@REPO@@")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

coord, pid = sys.argv[1], int(sys.argv[2])
from pir_tpu.parallel import distributed, sharded
distributed.init_distributed(coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.proto import payload as pb
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params

params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
raw = generate_test_db(30, params.bytes_per_item)   # seeded: same on both
db = PirDatabase.create(raw, params)
client = PirClient.create(params, seed=5)           # seeded: same keys

mesh = distributed.global_mesh(batch=1)             # db=4 spans processes
pipeline = sharded.make_sharded_pipeline(
    db.ctx, params.dimensions, np.asarray(db.db_ntt), mesh,
)
idx = 17
q = distributed.replicate_to_mesh(
    np.stack([client._create_query(idx)]), mesh
)
gk = {
    e: distributed.replicate_to_mesh(np.asarray(k.data), mesh)
    for e, k in client.galois_keys.keys.items()
}
replies = jax.block_until_ready(pipeline(q, gk))
out_local = np.asarray(replies)                     # fully replicated

resp = pb.Response()
wire.save_ciphertexts(out_local[0], resp.reply.add())
got = client.process_response([idx], resp)[0]
assert got == raw[idx], (pid, got, raw[idx])
print(f"proc{pid} OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_smoke(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("@@REPO@@", str(REPO)))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-4000:]}"
        assert f"proc{pid} OK" in out


_WORKER_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, "@@REPO@@")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

coord, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from pir_tpu.parallel import distributed, sharded
distributed.init_distributed(coord, num_processes=2, process_id=pid)

from pir_tpu.core.context import PirContext
from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.proto import payload as pb
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params

params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
raw = generate_test_db(30, params.bytes_per_item)   # seeded: same on both
ctx = PirContext.for_params(params)

# every process streams the (seeded, identical) DB into its own shard
# checkpoints, then loads ONLY the rows its db-axis devices own — the
# multi-host ingest contract: no process materializes the full database
my_dir = os.path.join(out_dir, f"proc{pid}")
PirDatabase.ingest_shards(iter(raw), params, my_dir, n_shards=4)
mesh = distributed.global_mesh(batch=1)             # db=4 spans processes
ranges = PirDatabase(params).shard_row_ranges(4)
my_shards = [2 * pid, 2 * pid + 1]
rows = [
    PirDatabase.load_shard_rows(my_dir, s)[: r1 - r0]
    for s, (r0, r1) in ((s, ranges[s]) for s in my_shards)
    if r1 > r0
]
local = np.concatenate(rows) if rows else np.zeros((0, ctx.n), np.uint64)
dims = params.dimensions
rows_total = (-(-dims[0] // 4) * 4) * int(np.prod(dims[1:]))
db_blocks = distributed.db_from_shard_rows(
    params, ctx, local, mesh, row_start=pid * rows_total // 2
)
pipeline = sharded.make_sharded_pipeline(ctx, dims, db_blocks, mesh)

client = PirClient.create(params, seed=5)           # seeded: same keys
idx = 17
q = distributed.replicate_to_mesh(
    np.stack([client._create_query(idx)]), mesh
)
gk = {
    e: distributed.replicate_to_mesh(np.asarray(k.data), mesh)
    for e, k in client.galois_keys.keys.items()
}
replies = jax.block_until_ready(pipeline(q, gk))
out_local = np.asarray(replies)

resp = pb.Response()
wire.save_ciphertexts(out_local[0], resp.reply.add())
got = client.process_response([idx], resp)[0]
assert got == raw[idx], (pid, got, raw[idx])
print(f"proc{pid} SHARDS OK", flush=True)
"""


def test_two_process_shard_checkpoints(tmp_path):
    """Per-process shard loading: each process ingests to its own
    checkpoint files, loads only its db-axis rows, and the assembled
    global database operand serves the query (BASELINE config-5 ingest
    contract)."""
    script = tmp_path / "worker_shards.py"
    script.write_text(_WORKER_SHARDS.replace("@@REPO@@", str(REPO)))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-4000:]}"
        assert f"proc{pid} SHARDS OK" in out
