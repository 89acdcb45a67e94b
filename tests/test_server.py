"""Server endpoint behavior: batched path, key cache, robustness."""

import numpy as np
import pytest

from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.pir.server import PirServer
from pir_tpu.proto import payload as pb
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params


@pytest.fixture(scope="module")
def stack():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, 8)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=4)
    server = PirServer.create(db, params)
    return params, raw, db, client, server


def test_batched_matches_sequential(stack):
    params, raw, db, client, server = stack
    indices = [2, 17, 29]
    req = client.create_request(indices)
    seq = server.process_request(req)
    bat = server.process_request_batched(req)
    assert len(seq.reply) == len(bat.reply)
    for a, b in zip(seq.reply, bat.reply):
        assert list(a.ct) == list(b.ct)
    out = client.process_response(indices, bat)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]


def test_process_stream_matches_sequential(stack):
    """process_stream (fetch-thread pipelining) yields responses in
    request order, byte-identical to sequential process_request."""
    params, raw, db, client, server = stack
    indices = [5, 0, 29, 12, 7]
    reqs = [client.create_request([i]) for i in indices]
    expected = [server.process_request(r) for r in reqs]
    got = list(server.process_stream(iter(reqs), depth=3))
    assert len(got) == len(expected)
    for want, have, idx in zip(expected, got, indices):
        assert [list(r.ct) for r in want.reply] == [
            list(r.ct) for r in have.reply
        ]
        assert client.process_response([idx], have)[0] == raw[idx]
    with pytest.raises(ValueError, match="depth"):
        list(server.process_stream(iter(reqs), depth=0))


def test_key_digest_sampling():
    """Small blobs hash fully; large blobs hash sampled windows — equal
    blobs collide, blobs differing in any sampled window or in length
    do not."""
    d = PirServer._key_digest
    small_a, small_b = b"a" * 1000, b"b" * 1000
    assert d(small_a, b"") == d(small_a, b"")
    assert d(small_a, b"") != d(small_b, b"")
    assert d(small_a, b"") != d(b"", small_a)  # field separation
    big = bytearray(1_000_000)
    big2 = bytearray(big)
    big2[5] = 1  # head window
    big3 = bytearray(big)
    big3[-5] = 1  # tail window
    assert d(bytes(big), b"") == d(bytes(big), b"")
    assert d(bytes(big), b"") != d(bytes(big2), b"")
    assert d(bytes(big), b"") != d(bytes(big3), b"")
    assert d(bytes(big), b"") != d(bytes(big) + b"x", b"")  # length


def test_key_cache_hit_and_isolation(stack):
    params, raw, db, client, server = stack
    req = client.create_request([5])
    server.process_request(req)
    assert len(server._key_cache) >= 1
    n_before = len(server._key_cache)
    server.process_request(req)  # same keys -> no new entry
    assert len(server._key_cache) == n_before
    # a different client's keys get their own entry and still work
    client2 = PirClient.create(params, seed=99)
    req2 = client2.create_request([7])
    resp2 = server.process_request(req2)
    assert len(server._key_cache) == n_before + 1
    assert client2.process_response([7], resp2)[0] == raw[7]
    # and the first client's subsequent requests are unaffected
    resp1 = server.process_request(client.create_request([5]))
    assert client.process_response([5], resp1)[0] == raw[5]


def test_zero_coefficient_query_is_harmless(stack):
    """The reference's zero-query robustness test (server_test.cpp:186-207):
    an all-zero query decrypts to zero, not an error."""
    params, raw, db, client, server = stack
    req = client.create_request([5])
    # replace the query ciphertext with an encryption of zero
    import jax.numpy as jnp
    from pir_tpu.bfv import encrypt as enc_mod

    zero_ct = np.asarray(
        enc_mod.encrypt_zero(client.ctx, client.pk, np.random.default_rng(0))
    )
    cts = wire.load_ciphertexts(req.query[0])
    cts[0] = zero_ct
    del req.query[0].ct[:]
    wire.save_ciphertexts(cts, req.query[0])
    resp = server.process_request(req)
    pt = client._process_reply(resp.reply[0])
    assert (pt == 0).all()


def test_db_size_mismatch_rejected():
    params = tiny_pir_params(dbsize=10, bytes_per_item=8, n=64)
    db = PirDatabase.create(generate_test_db(10, 8), params)
    params2 = tiny_pir_params(dbsize=30, bytes_per_item=8, n=64)
    with pytest.raises(ValueError):
        PirServer.create(db, params2)


def test_empty_request(stack):
    params, raw, db, client, server = stack
    req = pb.Request()
    req.galois_keys = client._galois_bytes
    resp = server.process_request(req)
    assert len(resp.reply) == 0


def test_split_pipeline_bit_exact():
    """Split-stage executables produce byte-identical replies to the
    monolithic jit (same integer ops, only jit boundaries move)."""
    from pir_tpu.testing.fixtures import generate_test_db
    from pir_tpu.testing.params import tiny_pir_params

    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    mono = PirServer(db, params, split_pipeline=False)
    split = PirServer(db, params, split_pipeline=True)
    req = client.create_request([7, 29])
    r_mono = mono.process_request(req)
    r_split = split.process_request(req)
    assert r_mono.SerializeToString() == r_split.SerializeToString()
    out = client.process_response([7, 29], r_split)
    assert out[0] == raw[7] and out[1] == raw[29]


def test_split_pipeline_multi_ct_query():
    """Split pipeline with dim_sum > N (multi-ciphertext queries)."""
    from pir_tpu.testing.fixtures import generate_test_db
    from pir_tpu.testing.params import tiny_pir_params

    params = tiny_pir_params(dbsize=90, bytes_per_item=88, dimensions=1, n=64)
    raw = generate_test_db(90, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    mono = PirServer(db, params, split_pipeline=False)
    split = PirServer(db, params, split_pipeline=True)
    req = client.create_request([0, 80, 89])
    assert (
        mono.process_request(req).SerializeToString()
        == split.process_request(req).SerializeToString()
    )


@pytest.mark.parametrize(
    "stats,expect",
    [
        (None, 4 << 30),  # CPU: no memory statistics
        ({}, 4 << 30),
        ({"bytes_limit": 60 << 30, "bytes_in_use": 4 << 30}, 28 << 30),
        ({"bytes_limit": 10 << 30}, 5 << 30),
    ],
)
def test_batch_budget_from_memory_stats(stats, expect):
    from pir_tpu.pir import server as server_mod

    assert server_mod.batch_budget(stats) == expect


def test_vmap_lanes_follow_device_memory(stack, monkeypatch):
    """The vmapped batch width is the free-memory budget over the
    per-lane estimate, at least 1."""
    from pir_tpu.pir import server as server_mod

    params, raw, db, client, server = stack
    lane = 3 * db.padded_size * 2 * db.ctx.L * db.ctx.n * 8
    monkeypatch.setattr(server_mod, "batch_budget", lambda stats: 5 * lane + 1)
    assert server._max_vmap_lanes() == 5
    monkeypatch.setattr(server_mod, "batch_budget", lambda stats: 0)
    assert server._max_vmap_lanes() == 1


def test_batched_ragged_lanes_match_sequential(stack, monkeypatch):
    """A batch wider than the lane cap runs in chunks (ragged tail
    included) and matches sequential serving byte for byte."""
    params, raw, db, client, server = stack
    monkeypatch.setattr(PirServer, "_max_vmap_lanes", lambda self: 2)
    indices = [1, 9, 23]
    req = client.create_request(indices)
    bat = server.process_request_batched(req)
    seq = server.process_request(req)
    assert bat.SerializeToString() == seq.SerializeToString()
    out = client.process_response(indices, bat)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]
