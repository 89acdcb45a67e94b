"""Seeded symmetric encryption and the compressed-query wire path.

No reference analog (the reference sends full fresh ciphertexts,
pir/cpp/client.cpp:136-140) — this is SEAL's seeded encrypt_symmetric
wire optimization: the query's second polynomial travels as a 16-byte
PRG seed, halving upload bytes.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as enc_mod
from pir_tpu.bfv import keys as keys_mod
from pir_tpu.core.context import PirContext
from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.pir.server import PirServer
from pir_tpu.proto import payload as pb
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params


@pytest.fixture(scope="module")
def setup():
    params = tiny_pir_params(dbsize=40, bytes_per_item=8, dimensions=2, n=64)
    ctx = PirContext(params)
    rng = np.random.default_rng(21)
    sk = keys_mod.gen_secret_key(ctx, rng)
    return params, ctx, sk, rng


def test_symmetric_seeded_decrypts(setup):
    params, ctx, sk, rng = setup
    m = rng.integers(0, ctx.t, size=ctx.n, dtype=np.uint64)
    c0, seed = enc_mod.encrypt_symmetric_seeded(ctx, sk, m, rng)
    assert len(seed) == 16
    ct = jnp.asarray(np.stack([c0, enc_mod.expand_a_from_seed(ctx, seed)]))
    assert np.array_equal(enc_mod.decrypt(ctx, sk, ct), m)


def test_seed_expansion_is_deterministic(setup):
    params, ctx, sk, rng = setup
    seed = bytes(range(16))
    a1 = enc_mod.expand_a_from_seed(ctx, seed)
    a2 = enc_mod.expand_a_from_seed(ctx, seed)
    assert np.array_equal(a1, a2)
    assert not np.array_equal(a1, enc_mod.expand_a_from_seed(ctx, bytes(16)))


def test_wire_roundtrip_seeded(setup):
    params, ctx, sk, rng = setup
    m = rng.integers(0, ctx.t, size=ctx.n, dtype=np.uint64)
    c0, seed = enc_mod.encrypt_symmetric_seeded(ctx, sk, m, rng)
    msg = wire.save_seeded_ciphertexts(c0[None], [seed])
    # byte budget: c0 + seed ≈ half a full ciphertext
    full = wire.pack_array(np.zeros((2, ctx.L, ctx.n), dtype=np.uint64))
    assert len(msg.ct[0]) < len(full) * 0.55
    cts = wire.load_ciphertexts(msg, ctx)
    assert cts.shape == (1, 2, ctx.L, ctx.n)
    assert np.array_equal(enc_mod.decrypt(ctx, sk, jnp.asarray(cts[0])), m)


def test_load_seeded_without_ctx_rejected(setup):
    params, ctx, sk, rng = setup
    c0, seed = enc_mod.encrypt_symmetric_seeded(
        ctx, sk, np.zeros(ctx.n, dtype=np.uint64), rng
    )
    msg = wire.save_seeded_ciphertexts(c0[None], [seed])
    with pytest.raises(ValueError, match="context"):
        wire.load_ciphertexts(msg)


def test_seed_length_validated(setup):
    params, ctx, sk, rng = setup
    c0 = np.zeros((1, ctx.L, ctx.n), dtype=np.uint64)
    with pytest.raises(ValueError, match="16-byte"):
        wire.save_seeded_ciphertexts(c0, [b"short"])
    with pytest.raises(ValueError, match="one seed"):
        wire.save_seeded_ciphertexts(c0, [])


@pytest.mark.parametrize("dimensions", [1, 2])
def test_pir_roundtrip_compressed_queries(dimensions):
    params = tiny_pir_params(
        dbsize=40, bytes_per_item=8, dimensions=dimensions, n=64
    )
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=22)
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=23, compress_queries=True)
    server = PirServer.create(db, params)

    indices = [0, 17, params.num_items - 1]
    request = client.create_request(indices)
    # the wire actually carries seeded (PTS1) ciphertexts
    assert request.query[0].ct[0][:4] == b"PTS1"
    response = server.process_request(request)
    assert client.process_response(indices, response) == [
        raw[i] for i in indices
    ]


def test_pir_batched_path_with_compressed_queries_and_shrunken_reply():
    """Both wire optimizations together, through the batched serve path."""
    params = tiny_pir_params(
        dbsize=40,
        bytes_per_item=8,
        dimensions=2,
        n=128,
        q_bits=(30, 30, 32),
    )
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed=24)
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=25, compress_queries=True)
    server = PirServer(db, params, reply_limbs=1)

    indices = [3, 25]
    response = server.process_request_batched(client.create_request(indices))
    assert client.process_response(indices, response) == [
        raw[i] for i in indices
    ]
