"""Multi-host (multi-process) execution scaffold.

The reference is single-process (SURVEY §2c); BASELINE's scaling ladder
("1 chip / 1 host / N>=2 hosts") makes the cross-host rung a new design
obligation.  The layout follows the sharded-pipeline contract
(parallel/sharded.py): the **"db" mesh axis is outermost and spans
hosts**, so the only cross-host collective is the single homomorphic-add
``psum`` that reduces per-shard partial replies — one network transfer of
one reply-sized array per query batch.  "batch" and "limb" axes nest
inside a host, so expansion-key traffic and the two limb collectives
(key-switch psum, digit all_gather) stay on the host's GPU interconnect.

Usage on each host/process::

    from pir_tpu.parallel import distributed, sharded
    distributed.init_distributed("host0:8476", num_processes=4, process_id=i)
    mesh = distributed.global_mesh(batch=2)        # db spans hosts
    pipeline = sharded.make_sharded_pipeline(ctx, dims, np.asarray(db_ntt),
                                             mesh)  # numpy -> replicated
    q = distributed.replicate_to_mesh(queries, mesh)
    gk = {e: distributed.replicate_to_mesh(k, mesh) for e, k in keys.items()}
    replies = pipeline(q, gk)                      # fully-addressable out

Exercised by the 2-process CPU smoke in tests/test_distributed.py.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: "str | None" = None,
    num_processes: "int | None" = None,
    process_id: "int | None" = None,
    local_device_ids=None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Wraps ``jax.distributed.initialize``: process 0 hosts the coordination
    service at ``coordinator_address``; afterwards ``jax.devices()`` spans
    every process and global meshes (``global_mesh``) span hosts.
    On clusters whose launcher exports the coordinator, process count
    and process id (e.g. SLURM), all three may be omitted.
    """
    from jax._src import distributed as _dist_state

    if getattr(_dist_state.global_state, "client", None) is not None:
        return  # already initialized (must not touch the XLA backend here)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_mesh(batch: int = 1, limb: int = 1) -> Mesh:
    """("db", "batch"[, "limb"]) mesh over ALL processes' devices.

    Device order is process-major (jax.devices() enumerates process 0's
    devices first), and the db axis is outermost — so consecutive db
    shards stay on one host until it is full, and batch/limb axes always
    fall within a host.  batch*limb must divide the per-process device
    count for that property to hold.
    """
    devices = np.asarray(jax.devices())
    per_proc = len(jax.local_devices())
    if batch * limb > per_proc and jax.process_count() > 1:
        raise ValueError(
            f"batch*limb = {batch * limb} exceeds the per-host device "
            f"count {per_proc}; batch/limb axes must nest inside a host"
        )
    n = devices.size
    if n % (batch * limb) != 0:
        raise ValueError(
            f"device count {n} not divisible by batch*limb = {batch * limb}"
        )
    if limb > 1:
        return Mesh(
            devices.reshape(n // (batch * limb), batch, limb),
            axis_names=("db", "batch", "limb"),
        )
    return Mesh(devices.reshape(n // batch, batch), axis_names=("db", "batch"))


def replicate_to_mesh(x, mesh: Mesh):
    """Host numpy -> fully-replicated global jax.Array on the mesh.

    Every process must pass the same value (deterministic from shared
    state — e.g. a request read by all hosts).  Needed because a plain
    ``jnp.asarray`` is process-local and cannot feed a global-mesh
    computation in multi-process mode.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def db_from_shard_rows(params, ctx, local_pts, mesh: Mesh, row_start: int):
    """This process's DB shard -> its slice of the global scan operand.

    The multi-host ingest contract (BASELINE config 5): each process
    loads ONLY its own plaintext rows (PirDatabase.load_shard_rows over
    the per-shard checkpoints written by ingest_shards), NTT-transforms
    them locally, and assembles the global blocked database operand for
    make_sharded_pipeline without any process ever holding the full
    database.

    local_pts: u64[rows_local, N] — the contiguous plaintext rows this
    process's db-axis shards own, starting at global row `row_start`
    (rows past params.num_pt are implicit zeros and may be omitted).
    Returns a global jax.Array u64[D0p, prod(dims[1:]), L, N], its first
    axis split over "db" (the blocked layout make_sharded_pipeline takes).
    """
    import jax.numpy as jnp

    from pir_tpu.bfv import evaluator

    dims = params.dimensions
    n_db = dict(mesh.shape).get("db", 1)
    d0 = dims[0]
    block = 1
    for d in dims[1:]:
        block *= d
    d0p = -(-d0 // n_db) * n_db
    rows_proc = d0p * block // jax.process_count()
    if rows_proc % block:
        raise ValueError("per-process rows must align to whole D0 blocks")
    if row_start != jax.process_index() * rows_proc:
        raise ValueError(
            f"row_start {row_start} is not this process's range "
            f"(expected {jax.process_index() * rows_proc})"
        )
    local_pts = np.asarray(local_pts)
    if local_pts.shape[0] > rows_proc:
        raise ValueError("more local rows than this process's range")
    padded = np.zeros((rows_proc, ctx.n), dtype=np.uint64)
    padded[: local_pts.shape[0]] = local_pts

    @jax.jit
    def prep(raw):
        ntt = evaluator.plaintext_to_ntt(ctx, raw)
        return ntt.reshape(rows_proc // block, block, ctx.L, ctx.n)

    with jax.default_device(jax.local_devices()[0]):
        local = jax.device_get(prep(jnp.asarray(padded)))
    limb = "limb" if "limb" in mesh.axis_names else None
    sharding = NamedSharding(mesh, P("db", None, limb, None))
    return jax.make_array_from_process_local_data(
        sharding, local, (d0p, block, ctx.L, ctx.n)
    )
