"""PirDatabase: encode, pre-transform, and scan the plaintext database.

Parity with the reference's PIRDatabase (pir/cpp/database.{h,cpp}):
populate from byte-strings (StringEncoder packing, items_per_plaintext per
poly) or int64s (IntegerEncoder, one per poly); in decomposition mode the
encoded plaintexts are NTT-transformed once at setup
(database.cpp:73-75,103-106) — the persistent artifact worth checkpointing
at scale (SURVEY §5d).

Differences by design: the plaintext hypercube is zero-padded to
prod(dimensions) so every scan has static shapes (mathematically identical
to the reference's early-break iterator), and the whole multiply is one
jittable function.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax.numpy as jnp

from pir_tpu.bfv import evaluator
from pir_tpu.core.context import PirContext
from pir_tpu.core.params import PirParams
from pir_tpu.ops import scan
from pir_tpu.pir.encoders import IntegerEncoder, StringEncoder


class PirDatabase:
    def __init__(self, params: PirParams):
        self.params = params
        self.ctx = PirContext.for_params(params)
        self.db_pts: Optional[np.ndarray] = None  # u64[num_pt, N] mod t
        self.db_ntt: Optional[jnp.ndarray] = None  # u64[padded, L, N]

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, rawdb, params: PirParams) -> "PirDatabase":
        db = cls(params)
        if len(rawdb) and isinstance(rawdb[0], (int, np.integer)):
            db.populate_ints(rawdb)
        else:
            db.populate_strings(rawdb)
        return db

    @property
    def size(self) -> int:
        return self.params.num_pt

    @property
    def padded_size(self) -> int:
        total = 1
        for d in self.params.dimensions:
            total *= d
        return total

    # ------------------------------------------------------------------
    def populate_strings(self, rawdb: Sequence[bytes]) -> None:
        p = self.params
        if len(rawdb) != p.num_items:
            raise ValueError(
                f"database size {len(rawdb)} does not match params value "
                f"{p.num_items}"
            )
        enc = StringEncoder(
            self.ctx.n, self.ctx.t, p.bits_per_coeff
        )
        pts = self._native_pack(rawdb, enc)
        if pts is None:
            pts = np.zeros((p.num_pt, self.ctx.n), dtype=np.uint64)
            for i in range(p.num_pt):
                chunk = rawdb[
                    i * p.items_per_plaintext : (i + 1) * p.items_per_plaintext
                ]
                pts[i] = enc.encode_many(chunk)
        self._finalize(pts)

    def _native_pack(self, rawdb, enc: StringEncoder):
        """Bulk-ingest through the C++ encoder when items are uniform.

        Zero-padding the final partial plaintext's byte buffer yields
        bit-identical coefficients to the reference's shorter encode (the
        trailing partial coefficient is left-justified either way and the
        remaining coefficients are zero).
        """
        from pir_tpu import native

        p = self.params
        if not native.available():
            return None
        if any(len(item) != p.bytes_per_item for item in rawdb):
            return None
        bytes_per_pt = p.items_per_plaintext * p.bytes_per_item
        buffer = b"".join(bytes(item) for item in rawdb)
        buffer += b"\0" * (p.num_pt * bytes_per_pt - len(buffer))
        return native.pack_db(
            buffer, p.num_pt, bytes_per_pt, enc.bits_per_coeff, self.ctx.n
        )

    def populate_ints(self, rawdb: Sequence[int]) -> None:
        p = self.params
        if len(rawdb) != p.num_items:
            raise ValueError(
                f"database size {len(rawdb)} does not match params value "
                f"{p.num_items}"
            )
        enc = IntegerEncoder(self.ctx.n, self.ctx.t)
        pts = np.zeros((p.num_pt, self.ctx.n), dtype=np.uint64)
        for i, v in enumerate(rawdb):
            pts[i] = enc.encode(int(v))
        self._finalize(pts)

    def _finalize(self, pts: np.ndarray) -> None:
        import jax

        self.db_pts = pts
        padded = np.zeros((self.padded_size, self.ctx.n), dtype=np.uint64)
        padded[: pts.shape[0]] = pts
        self.db_ntt = jax.jit(lambda raw: evaluator.plaintext_to_ntt(self.ctx, raw))(
            jnp.asarray(padded)
        )

    # ------------------------------------------------------------------
    # persistence of the encoded/NTT-transformed database (SURVEY §5d):
    # the one-time setup artifact worth checkpointing at large scale.
    def save(self, path) -> None:
        if self.db_pts is None:
            raise ValueError("database not populated")
        np.savez_compressed(
            path,
            db_pts=self.db_pts,
            db_ntt=np.asarray(self.db_ntt),
            num_items=self.params.num_items,
        )

    # ------------------------------------------------------------------
    # Streaming sharded ingest + per-shard checkpoints — the 16M-item
    # rung (BASELINE config 5): a DB whose encoded form exceeds one
    # chip's HBM is ingested in constant memory and persisted as one
    # file per db-mesh shard, each feeding its own device/process.
    # ------------------------------------------------------------------
    def shard_row_ranges(self, n_shards: int) -> "list[tuple[int, int]]":
        """Contiguous plaintext-row range [start, end) owned by each
        db-mesh shard: the first hypercube dimension zero-padded to the
        shard count and split evenly — the identical split
        parallel/sharded.make_sharded_pipeline applies on the "db" axis,
        so shard s's file is exactly device s's operand slice."""
        dims = self.params.dimensions
        d0 = dims[0]
        block = 1
        for d in dims[1:]:
            block *= d
        d0p = -(-d0 // n_shards) * n_shards
        rows = (d0p // n_shards) * block
        num_pt = self.params.num_pt
        return [
            (min(s * rows, num_pt), min((s + 1) * rows, num_pt))
            for s in range(n_shards)
        ]

    @classmethod
    def ingest_shards(
        cls,
        raw_iter,
        params: PirParams,
        out_dir,
        n_shards: int,
        chunk_pts: int = 2048,
    ) -> "list[str]":
        """Stream raw items into per-shard encoded checkpoints.

        raw_iter yields `params.num_items` byte strings of
        `params.bytes_per_item` each (any iterable — a generator reading
        from disk keeps peak memory at one chunk).  Items are packed
        `chunk_pts` plaintexts at a time through the native bulk encoder
        (pir_tpu/native/encoder.cpp; numpy fallback transparently) and
        written straight into per-shard .npy memmaps, so a 16M-item DB
        (≈0.5M plaintexts, 16 GB encoded) never materializes in RAM.
        Returns the shard file paths; `meta.json` records the layout.
        Bit-exact with populate_strings (same encoder, same row order).
        """
        import json
        import pathlib

        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        db = cls(params)
        p = params
        enc = StringEncoder(db.ctx.n, db.ctx.t, p.bits_per_coeff)
        ranges = db.shard_row_ranges(n_shards)
        paths = []
        maps = []
        for s, (r0, r1) in enumerate(ranges):
            path = out_dir / f"shard_{s:03d}.npy"
            paths.append(str(path))
            maps.append(
                np.lib.format.open_memmap(
                    path, mode="w+", dtype=np.uint64,
                    shape=(max(r1 - r0, 1), db.ctx.n),
                )
                if r1 > r0
                else None
            )
        bytes_per_pt = p.items_per_plaintext * p.bytes_per_item

        def write_rows(row0: int, pts: np.ndarray) -> None:
            # scatter a contiguous global row block into its shard files
            row1 = row0 + pts.shape[0]
            for s, (r0, r1) in enumerate(ranges):
                lo, hi = max(row0, r0), min(row1, r1)
                if lo < hi:
                    maps[s][lo - r0 : hi - r0] = pts[lo - row0 : hi - row0]

        it = iter(raw_iter)
        row = 0
        taken = 0
        from pir_tpu import native

        use_native = native.available()
        while row < p.num_pt:
            n_rows = min(chunk_pts, p.num_pt - row)
            want = n_rows * p.items_per_plaintext
            items = []
            while len(items) < want and taken < p.num_items:
                try:
                    item = next(it)
                except StopIteration:
                    raise ValueError(
                        f"iterator exhausted after {taken} items, params "
                        f"say {p.num_items}"
                    ) from None
                if len(item) != p.bytes_per_item:
                    raise ValueError(
                        f"item {taken} has {len(item)} bytes, expected "
                        f"{p.bytes_per_item}"
                    )
                items.append(bytes(item))
                taken += 1
            buffer = b"".join(items)
            buffer += b"\0" * (n_rows * bytes_per_pt - len(buffer))
            if use_native:
                pts = native.pack_db(
                    buffer, n_rows, bytes_per_pt, enc.bits_per_coeff, db.ctx.n
                )
            else:
                pts = np.zeros((n_rows, db.ctx.n), dtype=np.uint64)
                for i in range(n_rows):
                    chunk = items[
                        i * p.items_per_plaintext : (i + 1)
                        * p.items_per_plaintext
                    ]
                    if chunk:
                        pts[i] = enc.encode_many(chunk)
            write_rows(row, pts)
            row += n_rows
        if taken != p.num_items:
            raise ValueError(
                f"iterator yielded {taken} items, params say {p.num_items}"
            )
        for m in maps:
            if m is not None:
                m.flush()
        (out_dir / "meta.json").write_text(
            json.dumps(
                {
                    "num_items": p.num_items,
                    "num_pt": p.num_pt,
                    "n_shards": n_shards,
                    "dimensions": list(p.dimensions),
                    "row_ranges": ranges,
                }
            )
        )
        return paths

    @classmethod
    def load_shard_rows(cls, out_dir, shard: int) -> np.ndarray:
        """One shard's encoded plaintext rows (u64[rows, N] memmap) — the
        per-process load in a multi-host deployment; the NTT prep for
        the shard is one jit pass over exactly these rows."""
        import pathlib

        return np.load(
            pathlib.Path(out_dir) / f"shard_{shard:03d}.npy", mmap_mode="r"
        )

    @classmethod
    def load_shards(cls, out_dir, params: PirParams) -> "PirDatabase":
        """Reassemble a full database from per-shard checkpoints
        (single-process path; bit-exact with a direct create())."""
        import json
        import pathlib

        out_dir = pathlib.Path(out_dir)
        meta = json.loads((out_dir / "meta.json").read_text())
        if meta["num_items"] != params.num_items or tuple(
            meta["dimensions"]
        ) != tuple(params.dimensions):
            raise ValueError("shard checkpoint does not match parameters")
        db = cls(params)
        pts = np.zeros((params.num_pt, db.ctx.n), dtype=np.uint64)
        for s, (r0, r1) in enumerate(meta["row_ranges"]):
            if r1 > r0:
                pts[r0:r1] = cls.load_shard_rows(out_dir, s)[: r1 - r0]
        db._finalize(pts)
        return db

    @classmethod
    def load(cls, path, params: PirParams) -> "PirDatabase":
        data = np.load(path)
        if int(data["num_items"]) != params.num_items:
            raise ValueError("checkpoint does not match parameters")
        db = cls(params)
        db.db_pts = data["db_pts"]
        db.db_ntt = jnp.asarray(data["db_ntt"])
        return db

    def multiply(
        self, selection_vector: jnp.ndarray, relin_key=None, decryptor=None
    ) -> jnp.ndarray:
        """Scan: selection vector cts (coeff form, [dim_sum, 2, L, N]) ->
        reply cts (coeff form).  Parity with PIRDatabase::multiply
        (database.cpp:290-316).

        decryptor: optional callable(ct) -> noise-budget int.  When given,
        the scan runs eagerly and prints the invariant noise budget after
        each recursion level — the reference's server-side debug probe
        (database.h:127, database.cpp:260-270).
        """
        dim_sum = self.params.dimensions_sum
        if selection_vector.shape[0] != dim_sum:
            raise ValueError("selection vector size does not match dimensions")
        if self.db_ntt is None:
            raise ValueError("database not populated")
        if self.params.use_ciphertext_multiplication:
            if relin_key is None and len(self.params.dimensions) > 1:
                raise ValueError(
                    "ciphertext-multiplication mode with d > 1 requires "
                    "relinearization keys"
                )
            rk = getattr(relin_key, "key", relin_key)
            rk = getattr(rk, "data", rk)

            def build():
                def run(sv, db_ntt, key):
                    return scan.database_scan_ctmult(
                        self.ctx, db_ntt, self.params.dimensions, sv, key
                    )

                return run

            # dimensions ride in the cache name: contexts are shared per
            # PirParams, but a directly-constructed context could serve
            # databases with different dimension splits of the same sum
            return self.ctx.maybe_jitted(
                f"db_multiply_ctmult_{self.params.dimensions}",
                build, selection_vector, self.db_ntt, rk,
            )
        if decryptor is not None:
            # noise-budget probe decrypts intermediates: stay eager
            def probe(desc, cts):
                budgets = [decryptor(cts[i]) for i in range(min(2, cts.shape[0]))]
                print(f"noise budget after {desc}: {budgets}")

            sv_ntt = self.ctx.ntt_q.forward(selection_vector)
            return scan.database_scan_decomp(
                self.ctx,
                self.db_ntt,
                self.params.dimensions,
                sv_ntt,
                probe=probe,
            )

        def build():
            def run(sv, db_ntt):
                sv_ntt = self.ctx.ntt_q.forward(sv)
                return scan.database_scan_decomp(
                    self.ctx, db_ntt, self.params.dimensions, sv_ntt
                )

            return run

        return self.ctx.maybe_jitted(
            f"db_multiply_decomp_{self.params.dimensions}",
            build,
            selection_vector,
            self.db_ntt,
        )

    # ------------------------------------------------------------------
    # index math — parity with database.cpp:318-342
    def calculate_indices(self, index: int) -> list[int]:
        pt_index = index // self.params.items_per_plaintext
        out = []
        for d in reversed(self.params.dimensions):
            out.append(pt_index % d)
            pt_index //= d
        return list(reversed(out))

    def calculate_item_offset(self, index: int) -> int:
        p = self.params
        pt_index = index // p.items_per_plaintext
        return (index - pt_index * p.items_per_plaintext) * p.bytes_per_item
