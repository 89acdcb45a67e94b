"""PirClient: key generation, query construction, response decoding.

Parity with the reference's PIRClient (pir/cpp/client.{h,cpp}): owns the
secret/public/Galois/relinearization keys, pre-serializes the evaluation
keys once into a cached request skeleton (client.cpp:50-54), packs
per-dimension one-hot indices into ⌈dim_sum/N⌉ plaintexts with each hot
coefficient set to m⁻¹ mod t (pre-cancelling the expansion's scale factor,
client.cpp:92-144), and decodes replies by repeated
decrypt→digit-recompose rounds in decomposition mode (client.cpp:219-255).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax.numpy as jnp

from pir_tpu.bfv import encrypt as enc_mod
from pir_tpu.bfv import keys as keys_mod
from pir_tpu.core.context import PirContext
from pir_tpu.core.params import PirParams
from pir_tpu.ops import decompose
from pir_tpu.pir import wire
from pir_tpu.pir.database import PirDatabase
from pir_tpu.pir.encoders import IntegerEncoder, StringEncoder
from pir_tpu.proto import payload as pb
from pir_tpu.utils.math import generate_galois_elts, invert_mod, next_power_two


# (encryption_params, seed) -> (sk, pk, galois, relin, post-keygen rng state)
_KEYGEN_MEMO: dict = {}


class PirClient:
    def __init__(
        self,
        params: PirParams,
        seed: Optional[int] = None,
        compress_queries: bool = False,
        wire_format: str = "native",
    ):
        """compress_queries: serialize query ciphertexts in seeded
        symmetric form (c0 + 16-byte PRG seed, PTS1 codec) — half the
        upload bytes; the server re-expands them transparently.

        wire_format: "native" (PTP1, the default) or "seal" — every bytes
        field this client emits (query ciphertexts, Galois keys, relin
        keys) becomes a SEAL 3.5 stream, matching what the reference's
        PIRClient puts on the wire (client.cpp:50-54,136-140 via
        serialization.h:81-138).  SEAL mode implies full public-key query
        ciphertexts (the reference has no seeded-query compression)."""
        if wire_format not in ("native", "seal"):
            raise ValueError(f"unknown wire format {wire_format!r}")
        if wire_format == "seal" and compress_queries:
            raise ValueError(
                "seeded query compression is a native-codec extension; "
                "SEAL wire mode sends full ciphertexts"
            )
        if (
            wire_format == "seal"
            and len(params.dimensions) > 1
            and not params.use_ciphertext_multiplication
            and getattr(params, "reencode_mode", 0) != 0
        ):
            raise ValueError(
                "SEAL wire mode requires legacy re-encode digits (the "
                "reference's CiphertextReencoder cannot decode balanced-"
                'width replies) — create params with reencode_digits="legacy"'
            )
        self.wire_format = wire_format
        self.compress_queries = compress_queries
        self.params = params
        self.ctx = PirContext.for_params(params)
        self.db = PirDatabase(params)  # index math only, no data
        self._rng = np.random.default_rng(seed)
        # A seeded client's keys are a pure function of (encryption params,
        # seed): memoize the keygen (it dominates client construction at
        # N=4096) and replay the post-keygen rng state into self._rng so
        # subsequent query encryption randomness is bit-identical to an
        # uncached build.  seed=None clients always run fresh keygen.
        # SEAL wire mode generates the evaluation keys with stream-PRNG-
        # seeded a-polys so they serialize in SEAL's seeded (Serializable)
        # form — what the reference client actually sends (client.cpp:47-54)
        seeded_wire = wire_format == "seal"
        memo_key = (
            (params.encryption_params, seed, seeded_wire)
            if seed is not None
            else None
        )
        hit = _KEYGEN_MEMO.get(memo_key) if memo_key is not None else None
        if hit is None:
            with self.ctx.on_host():
                self.sk = keys_mod.gen_secret_key(self.ctx, self._rng)
                self.pk = keys_mod.gen_public_key(self.ctx, self.sk, self._rng)
                self.galois_keys = keys_mod.gen_galois_keys(
                    self.ctx, self.sk, generate_galois_elts(self.ctx.n),
                    self._rng, seeded_wire=seeded_wire,
                )
                self.relin_keys = keys_mod.gen_relin_key(
                    self.ctx, self.sk, self._rng, seeded_wire=seeded_wire
                )
            if memo_key is not None:
                if len(_KEYGEN_MEMO) >= 16:
                    _KEYGEN_MEMO.pop(next(iter(_KEYGEN_MEMO)))
                _KEYGEN_MEMO[memo_key] = (
                    self.sk,
                    self.pk,
                    self.galois_keys,
                    self.relin_keys,
                    self._rng.bit_generator.state,
                )
        else:
            self.sk, self.pk, self.galois_keys, self.relin_keys, state = hit
            self._rng = np.random.default_rng()
            self._rng.bit_generator.state = state
        # cache the serialized evaluation keys once (client.cpp:50-54)
        seal_ep = params.encryption_params if wire_format == "seal" else None
        self._galois_bytes = wire.serialize_galois_keys(
            self.galois_keys, seal_ep=seal_ep, n=self.ctx.n
        )
        self._relin_bytes = wire.serialize_relin_keys(
            self.relin_keys, seal_ep=seal_ep
        )

    @classmethod
    def create(cls, params: PirParams, seed: Optional[int] = None) -> "PirClient":
        return cls(params, seed)

    # ------------------------------------------------------------------
    def create_request(self, indexes: Sequence[int]) -> pb.Request:
        if self.compress_queries:
            req = pb.Request()
            for i in indexes:
                c0s, seeds = self._create_query_seeded(i)
                wire.save_seeded_ciphertexts(c0s, seeds, req.query.add())
            req.galois_keys = self._galois_bytes
            req.relin_keys = self._relin_bytes
            return req
        queries = [self._create_query(i) for i in indexes]
        if self.wire_format == "seal":
            req = pb.Request()
            for q in queries:
                wire.save_ciphertexts(
                    q, req.query.add(), seal_ep=self.params.encryption_params
                )
            req.galois_keys = self._galois_bytes
            req.relin_keys = self._relin_bytes
            return req
        return wire.save_request(queries, self._galois_bytes, self._relin_bytes)

    def _query_plaintexts(self, desired_index: int) -> list[np.ndarray]:
        """One-hot query plaintexts, hot slots scaled by m⁻¹ mod t — the
        packing of client.cpp:92-144 — one per ⌈dim_sum/N⌉ ciphertext."""
        p = self.params
        if desired_index >= p.num_items:
            raise ValueError(f"invalid index {desired_index}")
        n = self.ctx.n
        t = self.ctx.t
        dims = list(p.dimensions)
        indices = self.db.calculate_indices(desired_index)
        dim_sum = p.dimensions_sum

        num_cts = dim_sum // n + 1
        offset = 0
        pts = []
        for c in range(num_cts):
            pt = np.zeros(n, dtype=np.uint64)
            while indices:
                if indices[0] + offset >= n:
                    # this dimension's hot slot spills into the next ct
                    indices[0] -= n - offset
                    dims[0] -= n - offset
                    offset = 0
                    break
                m = n if c < num_cts - 1 else next_power_two(dim_sum % n)
                pt[indices[0] + offset] = invert_mod(m, t)
                offset += dims[0]
                indices.pop(0)
                dims.pop(0)
                if offset >= n:
                    offset -= n
                    break
            pts.append(pt)
        return pts

    def _create_query(self, desired_index: int) -> np.ndarray:
        """One query: u64[num_cts, 2, L, N].  Port of client.cpp:92-144."""
        cts = []
        with self.ctx.on_host():
            for pt in self._query_plaintexts(desired_index):
                cts.append(
                    np.asarray(enc_mod.encrypt(self.ctx, self.pk, pt, self._rng))
                )
        return np.stack(cts)

    def _create_query_seeded(
        self, desired_index: int
    ) -> tuple[np.ndarray, list[bytes]]:
        """Seeded-symmetric query: (c0 stack u64[num_cts, L, N], seeds)."""
        c0s, seeds = [], []
        with self.ctx.on_host():
            for pt in self._query_plaintexts(desired_index):
                c0, seed = enc_mod.encrypt_symmetric_seeded(
                    self.ctx, self.sk, pt, self._rng
                )
                c0s.append(c0)
                seeds.append(seed)
        return np.stack(c0s), seeds

    # ------------------------------------------------------------------
    def process_response(
        self, indexes: Sequence[int], response: pb.Response
    ) -> list[bytes]:
        if len(indexes) != len(response.reply):
            raise ValueError("number of indexes must match number of replies")
        enc = StringEncoder(self.ctx.n, self.ctx.t, self.params.bits_per_coeff)
        out = []
        for idx, reply in zip(indexes, response.reply):
            pt = self._process_reply(reply)
            out.append(
                enc.decode(
                    pt,
                    self.params.bytes_per_item,
                    self.db.calculate_item_offset(idx),
                )
            )
        return out

    def process_response_ints(self, response: pb.Response) -> list[int]:
        enc = IntegerEncoder(self.ctx.n, self.ctx.t)
        return [
            enc.decode_int64(self._process_reply(r)) for r in response.reply
        ]

    def _process_reply(self, reply: pb.Ciphertexts) -> np.ndarray:
        if self.params.use_ciphertext_multiplication:
            return self._process_reply_ct_mult(reply)
        return self._process_reply_decomp(reply)

    def _process_reply_ct_mult(self, reply: pb.Ciphertexts) -> np.ndarray:
        cts = wire.load_ciphertexts(reply, self.ctx)
        if cts.shape[0] != 1:
            raise ValueError(
                "number of ciphertexts in reply must be 1 when using CT "
                "multiplication"
            )
        with self.ctx.on_host():
            return enc_mod.decrypt(self.ctx, self.sk, jnp.asarray(cts[0]))

    def _process_reply_decomp(self, reply: pb.Ciphertexts) -> np.ndarray:
        """d rounds of decrypt → digit-recompose (client.cpp:219-255)."""
        exp_ratio = decompose.expansion_ratio(self.ctx) * 2
        num_dims = len(self.params.dimensions)
        expected = exp_ratio ** (num_dims - 1)
        cts = wire.load_ciphertexts(reply, self.ctx)
        if cts.shape[0] != expected:
            raise ValueError(
                "number of ciphertexts in reply does not match expected"
            )
        pts = None
        for _ in range(num_dims):
            with self.ctx.on_host():
                pts = np.stack(
                    [
                        enc_mod.decrypt(self.ctx, self.sk, jnp.asarray(cts[i]))
                        for i in range(cts.shape[0])
                    ]
                )
            if pts.shape[0] <= 1:
                break
            cts = np.stack(
                [
                    decompose.compose_ct(
                        self.ctx, pts[i * exp_ratio : (i + 1) * exp_ratio], 2
                    )
                    for i in range(pts.shape[0] // exp_ratio)
                ]
            )
        return pts[0]
