"""PirServer: request processing — expansion + scan, jitted end-to-end.

Parity with the reference's PIRServer (pir/cpp/server.{h,cpp}): deserialize
evaluation keys, then per query run oblivious expansion followed by the
database multiply, and serialize the reply.

Structure: the per-query pipeline (expansion levels + hypercube scan) is
jitted with static shapes; the Galois keys are traced inputs (they change
per request) and the NTT-form database rides as a device-resident
argument.  Batched requests re-use the same compiled executables.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Optional

import jax
import jax.numpy as jnp

from pir_tpu.core.params import PirParams
from pir_tpu.ops import expand, packing, scan
from pir_tpu.pir import wire
from pir_tpu.pir.database import PirDatabase
from pir_tpu.proto import payload as pb
from pir_tpu.utils.math import generate_galois_elts


# Batch-memory budget where the device reports no memory statistics.
CPU_BATCH_BUDGET = 4 << 30


def batch_budget(stats) -> int:
    """Bytes the vmapped batch path may plan for, from a device's
    ``memory_stats()`` (None on backends without statistics)."""
    if not stats or "bytes_limit" not in stats:
        return CPU_BATCH_BUDGET
    return (int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))) // 2


class PirServer:
    def __init__(
        self,
        db: PirDatabase,
        params: PirParams,
        reply_limbs: Optional[int] = None,
        packed_transfer: bool = True,
        wire_format: str = "auto",
        split_pipeline: Optional[bool] = None,
        mesh=None,
    ):
        """reply_limbs: if set, mod-switch reply ciphertexts down to this
        many RNS limbs before serialization (ops/modswitch.py) — shrinks
        reply bytes by L/reply_limbs.  Transparent to the client (the limb
        count travels in the array shape).  Caller must leave enough noise
        budget: the margin drops by the bits of every dropped prime.

        packed_transfer: move query/reply arrays across the host<->device
        link as (u32 lo, u8/u16 hi) pairs instead of u64 (ops/packing.py)
        — bit-identical values, 25-37.5% fewer transfer bytes.

        wire_format: reply serialization — "native" (PTP1), "seal" (SEAL
        3.5 Ciphertext streams, serialization.h:81-98 parity), or "auto"
        (default): echo the format the request's query ciphertexts arrived
        in, so a reference client talking SEAL streams gets SEAL streams
        back without configuration.

        split_pipeline: run expansion levels and the scan as separate
        small executables (precompiled concurrently) instead of one
        monolithic jit.  Bit-exact either way (identical integer ops,
        only jit boundaries move); the split bounds first-request compile
        latency because XLA optimization time grows superlinearly with
        HLO size and the per-stage compiles run in parallel.  Default
        (None): on for accelerator backends, off for CPU (whose
        monolithic compile is already fast).

        mesh: a jax.sharding.Mesh (parallel/sharded.default_mesh) — serve
        every request through the multi-chip pipeline: DB rows sharded
        over the "db" axis (subtree-sharded expansion + psum reduction),
        request queries over "batch", RNS limbs over "limb".  The protocol
        surface (key cache, wire formats, async/batched serving) is
        unchanged; replies are bit-identical to single-chip serving.
        Decomposition mode only (the reference's benchmark mode)."""
        if wire_format not in ("auto", "native", "seal"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        self.wire_format = wire_format
        if split_pipeline is None:
            import jax

            split_pipeline = jax.default_backend() != "cpu"
        self.split_pipeline = split_pipeline
        self._warmed_shapes: set = set()
        if params.num_pt != db.size:
            raise ValueError("database size mismatch")
        if reply_limbs is not None and not (
            1 <= reply_limbs <= len(params.encryption_params.ct_modulus)
        ):
            raise ValueError("reply_limbs out of range for the modulus chain")
        if (
            mesh is not None
            and params.use_ciphertext_multiplication
            and "limb" in mesh.axis_names
        ):
            raise ValueError(
                "ciphertext-multiplication mode cannot shard the limb "
                "axis (BEHZ base extension crosses limbs); use db/batch"
            )
        self.mesh = mesh
        self.params = params
        self.db = db
        self.ctx = db.ctx
        self.reply_limbs = reply_limbs
        self._hi_dtype = (
            packing.hi_dtype_for(self.ctx.ct_moduli) if packed_transfer else None
        )
        self._expansion_elts = tuple(generate_galois_elts(self.ctx.n))
        # Device-resident evaluation keys, cached by request-bytes digest:
        # clients resend identical key blobs with every request (wire parity
        # with the reference); deserializing and uploading ~10MB of keys
        # per query would dominate the serve path.
        self._key_cache: dict = {}

    @classmethod
    def create(cls, db: PirDatabase, params: PirParams) -> "PirServer":
        return cls(db, params)

    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=8)
    def _pipeline(self, num_query_cts: int):
        """Compiled (expand + scan) for a given query-ct count.

        The database rides as jit *arguments* (device-resident handles),
        not closure constants — baking 100MB+ arrays into the HLO blows up
        compile time.
        """
        ctx = self.ctx
        dims = self.params.dimensions
        dim_sum = self.params.dimensions_sum
        keep = self.reply_limbs

        def shrink(reply):
            if keep is None:
                return reply
            from pir_tpu.ops import modswitch

            return modswitch.mod_switch_to(ctx, reply, keep)

        if self.params.use_ciphertext_multiplication:

            def run(query_cts, galois_key_arrays, relin_key, db_ntt):
                sv = expand.expand_query(
                    ctx, galois_key_arrays, query_cts, dim_sum
                )
                return shrink(
                    scan.database_scan_ctmult(ctx, db_ntt, dims, sv, relin_key)
                )

        else:

            def run(query_cts, galois_key_arrays, relin_key, db_ntt):
                del relin_key
                sv = expand.expand_query(
                    ctx, galois_key_arrays, query_cts, dim_sum
                )
                sv_ntt = ctx.ntt_q.forward(sv)
                return shrink(scan.database_scan_decomp(ctx, db_ntt, dims, sv_ntt))

        return jax.jit(run)

    @functools.lru_cache(maxsize=8)
    def _pipeline_packed(self, num_query_cts: int):
        """The same pipeline with packed-transfer endpoints: queries arrive
        as (u32 lo, u8/u16 hi) pairs, replies leave the same way."""
        single = self._pipeline(num_query_cts)
        dt = self._hi_dtype

        def run(q_lo, q_hi, galois_key_arrays, relin_key, db_ntt):
            q = packing.join_device(q_lo, q_hi)
            reply = single(q, galois_key_arrays, relin_key, db_ntt)
            return packing.split_device(reply, dt)

        return jax.jit(run)

    # ------------------------------------------------------------------
    # Split-stage pipeline: per-level expansion executables + one scan
    # executable, precompiled concurrently (see __init__ docstring).
    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=32)
    def _level_jit(self, j: int):
        ctx = self.ctx

        def run(cts, gk):
            return expand.expand_level(ctx, gk, cts, j)

        return jax.jit(run)

    @functools.lru_cache(maxsize=2)
    def _scan_jit(self):
        """(sv, relin_key, *db_operands) -> reply; sv in coefficient form."""
        ctx = self.ctx
        dims = self.params.dimensions
        keep = self.reply_limbs

        def shrink(reply):
            if keep is None:
                return reply
            from pir_tpu.ops import modswitch

            return modswitch.mod_switch_to(ctx, reply, keep)

        if self.params.use_ciphertext_multiplication:

            def run(sv, relin_key, db_ntt):
                return shrink(
                    scan.database_scan_ctmult(ctx, db_ntt, dims, sv, relin_key)
                )

        else:

            def run(sv, relin_key, db_ntt):
                del relin_key
                sv_ntt = ctx.ntt_q.forward(sv)
                return shrink(scan.database_scan_decomp(ctx, db_ntt, dims, sv_ntt))

        return jax.jit(run)

    def _expand_staged(self, cts_dev, gk_arrays):
        """expand_query via the per-level executables (bit-exact with
        expand.expand_query — same ops, different jit boundaries)."""
        from pir_tpu.utils.math import ceil_log2

        n = self.ctx.n
        total = self.params.dimensions_sum
        outs = []
        remaining = total
        for i in range(cts_dev.shape[0]):
            count = min(n, remaining)
            remaining -= n
            if count == 0:
                continue
            x = cts_dev[i][None]
            for j in range(ceil_log2(count)):
                x = self._level_jit(j)(x, gk_arrays)
            outs.append(x[:count])
        return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    def _levels_for(self, num_query_cts: int) -> set:
        from pir_tpu.utils.math import ceil_log2

        n = self.ctx.n
        remaining = self.params.dimensions_sum
        levels = set()
        for _ in range(num_query_cts):
            count = min(n, remaining)
            remaining -= n
            if count:
                levels.update(range(ceil_log2(count)))
        return levels

    @functools.lru_cache(maxsize=2)
    def _join_jit(self):
        return jax.jit(packing.join_device)

    @functools.lru_cache(maxsize=2)
    def _split_jit(self):
        dt = self._hi_dtype
        return jax.jit(lambda x: packing.split_device(x, dt))

    def _warm_split(self, num_query_cts: int):
        """Precompile the stage executables concurrently (XLA compiles
        release the interpreter lock, so the stages build in parallel)."""
        key = ("split", num_query_cts)
        if key in self._warmed_shapes:
            return
        from concurrent.futures import ThreadPoolExecutor

        ctx = self.ctx
        gk_zero = {
            e: jnp.zeros((ctx.L, 2, ctx.Lp, ctx.n), jnp.uint64)
            for e in self._expansion_elts
        }
        rk_zero = (
            jnp.zeros((ctx.L, 2, ctx.Lp, ctx.n), jnp.uint64)
            if self.params.use_ciphertext_multiplication
            else None
        )
        jobs = []
        for j in sorted(self._levels_for(num_query_cts)):
            x = jnp.zeros((1 << j, 2, ctx.L, ctx.n), jnp.uint64)
            jobs.append((self._level_jit(j), (x, gk_zero)))
        sv_zero = jnp.zeros(
            (self.params.dimensions_sum, 2, ctx.L, ctx.n), jnp.uint64
        )
        jobs.append((self._scan_jit(), (sv_zero, rk_zero, self.db.db_ntt)))
        with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            futures = [
                ex.submit(lambda f, a: jax.block_until_ready(f(*a)), f, a)
                for f, a in jobs
            ]
            for fut in futures:
                fut.result()
        # one dummy pass through the EXACT serve path (packed join/split,
        # staged expansion glue, scan, reply fetch) so the first real
        # request compiles nothing at all
        import numpy as np

        q_zero = np.zeros((num_query_cts, 2, ctx.L, ctx.n), np.uint64)
        handle = self._run_query_split_device_inner(q_zero, gk_zero, rk_zero)
        self._fetch_reply(handle)
        self._warmed_shapes.add(key)

    def _run_query_split_device(self, cts, gk_arrays, rk):
        """One query through the split-stage executables; device handles."""
        self._warm_split(cts.shape[0])
        return self._run_query_split_device_inner(cts, gk_arrays, rk)

    def _run_query_split_device_inner(self, cts, gk_arrays, rk):
        import numpy as np

        if self._hi_dtype is not None:
            lo, hi = packing.split_host(np.asarray(cts), self._hi_dtype)
            q = self._join_jit()(jnp.asarray(lo), jnp.asarray(hi))
        else:
            q = jnp.asarray(cts)
        sv = self._expand_staged(q, gk_arrays)
        reply = self._scan_jit()(sv, rk, self.db.db_ntt)
        if self._hi_dtype is not None:
            return self._split_jit()(reply)
        return reply

    def _run_query_device(self, cts, gk_arrays, rk):
        """One query stack (host u64[k, 2, L, N]) -> un-fetched device
        reply (a packed (lo, hi) pair when packed transfer is on).  The
        dispatch is asynchronous — callers may enqueue further queries
        before fetching (process_request_async)."""
        import numpy as np

        if self.split_pipeline:
            return self._run_query_split_device(cts, gk_arrays, rk)
        if self._hi_dtype is not None:
            lo, hi = packing.split_host(np.asarray(cts), self._hi_dtype)
            return self._pipeline_packed(cts.shape[0])(
                jnp.asarray(lo), jnp.asarray(hi), gk_arrays, rk,
                self.db.db_ntt,
            )
        return self._pipeline(cts.shape[0])(
            jnp.asarray(cts), gk_arrays, rk, self.db.db_ntt
        )

    def _fetch_reply(self, handle):
        """Device reply handle -> host u64 array (blocks on the transfer)."""
        if self._hi_dtype is not None:
            r_lo, r_hi = handle
            return packing.join_host(*jax.device_get((r_lo, r_hi)))
        return jax.device_get(handle)

    def _run_query(self, cts, gk_arrays, rk):
        """One query stack (host u64[k, 2, L, N]) -> host u64 reply."""
        return self._fetch_reply(self._run_query_device(cts, gk_arrays, rk))

    # ------------------------------------------------------------------
    @staticmethod
    def _key_digest(gal: bytes, rel: bytes) -> bytes:
        """Cache key for a request's evaluation-key blobs.

        Default: blake2b over (lengths, head/middle/tail 64KB samples of
        each blob).  Key blobs are uniformly-random polynomial data, so
        distinct honest key sets differ in every sampled window; a client
        crafting two blobs that collide only corrupts its own replies
        (the cache is consulted per request, with that request's blobs).
        Hashing the full ~5MB costs milliseconds of host time per
        request.  Set PIR_FULL_KEY_DIGEST=1 to hash everything.
        """
        h = hashlib.blake2b(digest_size=16)
        full = bool(os.environ.get("PIR_FULL_KEY_DIGEST"))
        for blob in (gal, rel):
            h.update(len(blob).to_bytes(8, "little"))
            if full or len(blob) <= 3 * 65536:
                h.update(blob)
            else:
                mid = len(blob) // 2
                h.update(blob[:65536])
                h.update(blob[mid : mid + 65536])
                h.update(blob[-65536:])
        return h.digest()

    def _device_keys(self, request: pb.Request):
        digest = self._key_digest(request.galois_keys, request.relin_keys)
        cached = self._key_cache.get(digest)
        if cached is not None:
            return cached
        ep = self.params.encryption_params
        galois = wire.deserialize_galois_keys(request.galois_keys, ep)
        gk_arrays = {e: jnp.asarray(k.data) for e, k in galois.keys.items()}
        missing = [e for e in self._expansion_elts if e not in gk_arrays]
        if missing:
            raise ValueError(
                f"request missing galois keys for elements {missing}"
            )
        rk = None
        if request.relin_keys:
            rk = jnp.asarray(
                wire.deserialize_relin_keys(request.relin_keys, ep).key.data
            )
        if len(self._key_cache) >= 8:
            self._key_cache.pop(next(iter(self._key_cache)))
        self._key_cache[digest] = (gk_arrays, rk)
        return gk_arrays, rk

    def _reply_seal_ep(self, request: pb.Request):
        """The reply codec for this request: SEAL emit iff configured, or
        (in "auto" mode) iff the query ciphertexts arrived as SEAL streams."""
        from pir_tpu.pir import seal_compat

        mode = self.wire_format
        if mode == "auto":
            is_seal = any(
                seal_compat.looks_like_seal_stream(q.ct[0])
                for q in request.query
                if len(q.ct)
            )
            mode = "seal" if is_seal else "native"
        if (
            mode == "seal"
            and len(self.params.dimensions) > 1
            and not self.params.use_ciphertext_multiplication
            and getattr(self.params, "reencode_mode", 0) != 0
        ):
            raise ValueError(
                "SEAL-wire request against balanced re-encode params: a "
                "reference client cannot recompose balanced-width reply "
                'digits — build the deployment with reencode_digits="legacy"'
            )
        return self.params.encryption_params if mode == "seal" else None

    # ------------------------------------------------------------------
    # Mesh-backed serving (parallel/sharded.py pipeline behind the same
    # protocol surface)
    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=1)
    def _mesh_pipeline(self):
        from pir_tpu.parallel import sharded

        if self.params.use_ciphertext_multiplication:
            return sharded.make_sharded_pipeline(
                self.ctx, self.params.dimensions, self.db.db_ntt, self.mesh,
                reply_limbs=self.reply_limbs, use_ct_mult=True,
            )
        return sharded.make_sharded_pipeline(
            self.ctx, self.params.dimensions, self.db.db_ntt, self.mesh,
            reply_limbs=self.reply_limbs,
        )

    def _process_request_async_mesh(self, request: pb.Request):
        import numpy as np

        from pir_tpu.parallel import sharded

        gk_arrays, rk = self._device_keys(request)
        if self.params.use_ciphertext_multiplication and rk is None and len(
            self.params.dimensions
        ) > 1:
            raise ValueError(
                "ciphertext-multiplication mode with d > 1 requires "
                "relinearization keys in the request"
            )
        if not self.params.use_ciphertext_multiplication:
            rk = None  # decomp pipeline takes no relin key operand
        seal_ep = self._reply_seal_ep(request)
        stacks = [wire.load_ciphertexts(q, self.ctx) for q in request.query]
        if not stacks:
            return ("mesh", None, 0, seal_ep)
        if len({s.shape for s in stacks}) != 1:
            raise ValueError(
                "mesh serving requires equal query shapes per request "
                "(always true for same-params clients)"
            )
        q = np.stack(stacks)
        batch = dict(self.mesh.shape).get("batch", 1)
        q = sharded.pad_axis(q, 0, batch)
        # packed endpoints as their own small executables: wrapping the
        # mesh pipeline in another jit would bake its database operand
        # into that program as a constant
        if self._hi_dtype is not None:
            lo, hi = packing.split_host(q, self._hi_dtype)
            q_dev = self._join_jit()(jnp.asarray(lo), jnp.asarray(hi))
            replies = self._split_jit()(
                self._mesh_pipeline()(q_dev, gk_arrays, rk)
            )
        else:
            replies = self._mesh_pipeline()(jnp.asarray(q), gk_arrays, rk)
        return ("mesh", replies, len(stacks), seal_ep)

    def process_request_async(self, request: pb.Request):
        """Dispatch a request's device work and return an opaque pending
        handle without waiting for the reply transfer.  A serving loop can
        keep several requests in flight (the next request's expansion and
        scan overlap the previous reply's host readback) — pass the handle
        to :meth:`finalize_response` to obtain the Response proto.  The
        reference's serve loop is strictly sequential (server.cpp:60-63);
        this is the pipelined shape of the same per-query semantics:
        replies are bit-identical and completed in order."""
        if self.mesh is not None:
            return self._process_request_async_mesh(request)
        gk_arrays, rk = self._device_keys(request)
        if self.params.use_ciphertext_multiplication and rk is None and len(
            self.params.dimensions
        ) > 1:
            raise ValueError(
                "ciphertext-multiplication mode with d > 1 requires "
                "relinearization keys in the request"
            )
        seal_ep = self._reply_seal_ep(request)
        handles = [
            self._run_query_device(
                wire.load_ciphertexts(query, self.ctx), gk_arrays, rk
            )
            for query in request.query
        ]
        return handles, seal_ep

    def finalize_response(self, pending) -> pb.Response:
        """Complete a process_request_async handle into a Response."""
        if pending[0] == "mesh":
            _, replies, count, seal_ep = pending
            response = pb.Response()
            if count:
                if self._hi_dtype is not None:
                    host = packing.join_host(*jax.device_get(replies))
                else:
                    host = jax.device_get(replies)
                for qi in range(count):
                    wire.save_ciphertexts(
                        host[qi], response.reply.add(), seal_ep=seal_ep
                    )
            return response
        handles, seal_ep = pending
        response = pb.Response()
        for handle in handles:
            reply = self._fetch_reply(handle)
            wire.save_ciphertexts(reply, response.reply.add(), seal_ep=seal_ep)
        return response

    def process_request(self, request: pb.Request) -> pb.Response:
        return self.finalize_response(self.process_request_async(request))

    def process_stream(self, requests, depth: int = 6):
        """Serve an iterable of Requests, yielding Responses in order.

        The caller's thread submits device work (process_request_async)
        while a dedicated worker thread completes reply transfers and
        serialization (finalize_response), with up to ``depth`` requests
        in flight, so the reply readback of request n overlaps the device
        compute of requests n+1..n+depth.  Replies are bit-identical to
        sequential process_request (the reference serves strictly
        sequentially, server.cpp:60-63).

        A worker failure is re-raised here on the next yield; remaining
        in-flight work is drained first.
        """
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        if depth < 1:
            raise ValueError("depth must be >= 1")
        pend: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as ex:
            for request in requests:
                handle = self.process_request_async(request)
                pend.append(ex.submit(self.finalize_response, handle))
                while len(pend) >= depth:
                    yield pend.popleft().result()
            while pend:
                yield pend.popleft().result()

    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=8)
    def _pipeline_batched(self, num_query_cts: int, batch: int):
        """vmapped multi-query pipeline: all queries of one request run as a
        single device program (the reference loops serially,
        server.cpp:60-63)."""
        single = self._pipeline(num_query_cts)

        def run(query_cts, galois_key_arrays, relin_key, db_ntt):
            return jax.vmap(
                lambda q: single(q, galois_key_arrays, relin_key, db_ntt)
            )(query_cts)

        return jax.jit(run)

    @functools.lru_cache(maxsize=8)
    def _pipeline_batched_packed(self, num_query_cts: int, batch: int):
        batched = self._pipeline_batched(num_query_cts, batch)
        dt = self._hi_dtype

        def run(q_lo, q_hi, galois_key_arrays, relin_key, db_ntt):
            q = packing.join_device(q_lo, q_hi)
            replies = batched(q, galois_key_arrays, relin_key, db_ntt)
            return packing.split_device(replies, dt)

        return jax.jit(run)

    def _max_vmap_lanes(self) -> int:
        """Cap the vmapped batch width by a device-memory transient estimate.

        Each vmap lane materializes roughly 3x the padded DB's stage-1
        working set (expanded selection vector, partial sums, NTT
        intermediates).  The budget is half of the device memory not yet
        in use (``memory_stats()["bytes_limit"]`` less ``bytes_in_use``);
        a backend without memory statistics (the CPU) gets
        ``CPU_BATCH_BUDGET``.
        """
        lane_bytes = 3 * self.db.padded_size * 2 * self.ctx.L * self.ctx.n * 8
        stats = self.db.db_ntt.devices().pop().memory_stats()
        return max(1, batch_budget(stats) // max(1, lane_bytes))

    def process_request_batched(self, request: pb.Request) -> pb.Response:
        """Like process_request, but runs queries in batched device programs:
        the vmapped whole pipeline, its width capped by the device-memory
        estimate above.  Requests whose queries differ in ciphertext count
        take the per-query path.
        """
        if self.mesh is not None:
            # the mesh pipeline is inherently batched over its "batch" axis
            return self.process_request(request)
        gk_arrays, rk = self._device_keys(request)
        seal_ep = self._reply_seal_ep(request)
        stacks = [wire.load_ciphertexts(q, self.ctx) for q in request.query]
        if len({s.shape for s in stacks}) != 1:
            return self.process_request(request)
        import numpy as np

        all_queries = np.stack(stacks)
        response = pb.Response()
        lanes = min(self._max_vmap_lanes(), all_queries.shape[0])
        for start in range(0, all_queries.shape[0], lanes):
            chunk = all_queries[start : start + lanes]
            if self._hi_dtype is not None:
                lo, hi = packing.split_host(chunk, self._hi_dtype)
                packed = self._pipeline_batched_packed(
                    chunk.shape[1], chunk.shape[0]
                )(
                    jnp.asarray(lo), jnp.asarray(hi), gk_arrays, rk,
                    self.db.db_ntt,
                )
                replies = packing.join_host(*jax.device_get(packed))
            else:
                replies = jax.device_get(
                    self._pipeline_batched(chunk.shape[1], chunk.shape[0])(
                        jnp.asarray(chunk), gk_arrays, rk,
                        self.db.db_ntt,
                    )
                )
            for qi in range(replies.shape[0]):
                wire.save_ciphertexts(
                    replies[qi], response.reply.add(), seal_ep=seal_ep
                )
        return response

    # ------------------------------------------------------------------
    # exposed for component tests (parity with server_test.cpp surfaces)
    def oblivious_expansion(self, cts, total_items: int, galois_keys):
        gk = {e: jnp.asarray(k.data) for e, k in galois_keys.keys.items()}
        cts = jnp.asarray(cts)
        if cts.ndim == 3:
            return expand.expand_single(self.ctx, gk, cts, total_items)
        return expand.expand_query(self.ctx, gk, cts, total_items)
