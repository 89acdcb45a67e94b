"""Sharded pipeline on the 8-device CPU mesh: sharded == unsharded."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.parallel import sharded
from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.pir.server import PirServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params


def _setup(d, dbsize=30):
    params = tiny_pir_params(dbsize=dbsize, bytes_per_item=8, dimensions=d, n=64)
    raw = generate_test_db(dbsize, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    server = PirServer.create(db, params)
    return params, raw, db, client, server


@pytest.mark.parametrize("d,batch", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_sharded_matches_unsharded(d, batch):
    assert len(jax.devices()) == 8
    params, raw, db, client, server = _setup(d)
    mesh = sharded.default_mesh(batch=batch)

    indices = [3, 17, 29, 11][: 2 * batch] or [3]
    queries = [client._create_query(i) for i in indices]
    q = sharded.pad_axis(jnp.asarray(np.stack(queries)), 0, mesh.shape["batch"])
    gk = {
        e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()
    }

    pipeline = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh
    )
    replies = pipeline(q, gk)

    # unsharded reference result, query by query
    for qi in range(len(indices)):
        single = server._pipeline(queries[qi].shape[0])(
            jnp.asarray(queries[qi]), gk, None, db.db_ntt
        )
        assert (np.asarray(replies[qi]) == np.asarray(single)).all(), qi


def test_sharded_end_to_end_decode():
    params, raw, db, client, server = _setup(2)
    mesh = sharded.default_mesh(batch=2)
    indices = [0, 29]
    queries = np.stack([client._create_query(i) for i in indices])
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}
    pipeline = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh
    )
    replies = np.asarray(pipeline(jnp.asarray(queries), gk))

    from pir_tpu.proto import payload as pb

    resp = pb.Response()
    for qi in range(len(indices)):
        wire.save_ciphertexts(replies[qi], resp.reply.add())
    out = client.process_response(indices, resp)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]


@pytest.mark.parametrize(
    "d,batch,limb,q_bits",
    [
        (1, 1, 2, (26, 27, 28)),
        (2, 1, 2, (26, 27, 28)),
        (2, 2, 2, (26, 27, 28)),
        # four ct limbs, 4-way limb mesh
        (2, 1, 4, (26, 27, 28, 29, 30)),
        # unequal digit ratios per limb (3 vs 4) exercise the padded
        # all-gather decomposition
        (2, 1, 2, (26, 34, 36)),
    ],
)
def test_limb_sharded_matches_unsharded(d, batch, limb, q_bits):
    assert len(jax.devices()) == 8
    params = tiny_pir_params(
        dbsize=30, bytes_per_item=8, dimensions=d, n=64, q_bits=q_bits
    )
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    server = PirServer.create(db, params)
    mesh = sharded.default_mesh(batch=batch, limb=limb)
    assert dict(mesh.shape)["limb"] == limb

    indices = [3, 17, 29, 11][: 2 * batch] or [3]
    queries = [client._create_query(i) for i in indices]
    q = sharded.pad_axis(
        jnp.asarray(np.stack(queries)), 0, dict(mesh.shape)["batch"]
    )
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}

    pipeline = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh
    )
    replies = pipeline(q, gk)

    for qi in range(len(indices)):
        single = server._pipeline(queries[qi].shape[0])(
            jnp.asarray(queries[qi]), gk, None, db.db_ntt
        )
        assert (np.asarray(replies[qi]) == np.asarray(single)).all(), qi


def test_limb_sharded_end_to_end_decode():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    mesh = sharded.default_mesh(batch=2, limb=2)  # db=2 x batch=2 x limb=2
    indices = [0, 29]
    queries = np.stack([client._create_query(i) for i in indices])
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}
    pipeline = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh
    )
    replies = np.asarray(pipeline(jnp.asarray(queries), gk))

    from pir_tpu.proto import payload as pb

    resp = pb.Response()
    for qi in range(len(indices)):
        wire.save_ciphertexts(replies[qi], resp.reply.add())
    out = client.process_response(indices, resp)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]


# Moduli widths of the test chains: the default (26, 27, 28), a 34/36-bit
# chain (the SEAL-default widths' regime: products above 64 bits) and a
# sub-32-bit chain (products that fit one u64 word).
_Q_BITS = [(26, 27, 28), (26, 34, 36), (20, 20, 19, 30)]


@pytest.mark.parametrize("d,batch", [(1, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("q_bits", _Q_BITS[1:])
def test_sharded_matches_unsharded_moduli_widths(d, batch, q_bits):
    """db x batch sharding is bit-exact vs the single-device pipeline at
    every modulus width class the scan's column sums handle."""
    params = tiny_pir_params(
        dbsize=30, bytes_per_item=8, dimensions=d, n=64, t_bits=10,
        q_bits=q_bits,
    )
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    server = PirServer.create(db, params)
    mesh = sharded.default_mesh(batch=batch)
    indices = [3, 17, 29, 11][: 2 * batch] or [3]
    queries = [client._create_query(i) for i in indices]
    q = sharded.pad_axis(jnp.asarray(np.stack(queries)), 0, mesh.shape["batch"])
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}

    replies = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh
    )(q, gk)
    for qi in range(len(indices)):
        single = server._pipeline(queries[qi].shape[0])(
            jnp.asarray(queries[qi]), gk, None, db.db_ntt
        )
        assert (np.asarray(replies[qi]) == np.asarray(single)).all(), qi


def test_blocked_database_operand_matches_flat():
    """The pre-blocked [D0p, B, L, N] operand (the multi-host assembly's
    layout) gives the same replies as the flat database."""
    params, raw, db, client, server = _setup(2)
    mesh = sharded.default_mesh(batch=1)
    n_db = mesh.shape["db"]
    d0, block = params.dimensions[0], params.dimensions[1]
    blocked = sharded.pad_axis(
        jnp.asarray(db.db_ntt).reshape(d0, block, db.ctx.L, db.ctx.n), 0, n_db
    )
    q = jnp.asarray(np.stack([client._create_query(17)]))
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}
    flat = sharded.make_sharded_pipeline(db.ctx, params.dimensions, db.db_ntt, mesh)
    blk = sharded.make_sharded_pipeline(db.ctx, params.dimensions, blocked, mesh)
    assert (np.asarray(flat(q, gk)) == np.asarray(blk(q, gk))).all()
    with pytest.raises(ValueError, match="blocked"):
        sharded.make_sharded_pipeline(
            db.ctx, params.dimensions, blocked[:, :-1], mesh
        )


@pytest.mark.parametrize("batch,limb", [(1, 1), (2, 1), (2, 2)])
def test_mesh_backed_server_roundtrip(batch, limb):
    """PirServer(mesh=...) serves the full protocol surface — proto in,
    proto out — through the sharded pipeline, bit-exact vs the single-chip
    server (the serving surface of server.cpp:44-63 on a mesh)."""
    params, raw, db, client, server = _setup(2)
    mesh = sharded.default_mesh(batch=batch, limb=limb)
    mesh_server = PirServer(db, params, mesh=mesh)

    indices = [3, 17, 29][: max(2, batch)]
    request = client.create_request(indices)
    resp_mesh = mesh_server.process_request(request)
    resp_single = server.process_request(request)
    assert resp_mesh.SerializeToString() == resp_single.SerializeToString()
    out = client.process_response(indices, resp_mesh)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]
    # batched entry routes through the same mesh pipeline
    resp_b = mesh_server.process_request_batched(request)
    assert resp_b.SerializeToString() == resp_single.SerializeToString()


@pytest.mark.parametrize("d,batch", [(1, 2), (2, 1)])
def test_mesh_backed_server_ct_mult_roundtrip(d, batch):
    """Ciphertext-multiplication recursion through the mesh server
    (db/batch axes): proto-identical to single-chip, decodes correctly."""
    params = tiny_pir_params(
        dbsize=30, bytes_per_item=8, dimensions=d, n=64,
        use_ciphertext_multiplication=True,
    )
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    server = PirServer.create(db, params)
    mesh_server = PirServer(
        db, params, mesh=sharded.default_mesh(batch=batch)
    )
    indices = [3, 29]
    request = client.create_request(indices)
    resp_mesh = mesh_server.process_request(request)
    resp_single = server.process_request(request)
    assert resp_mesh.SerializeToString() == resp_single.SerializeToString()
    out = client.process_response(indices, resp_mesh)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]


def test_mesh_backed_server_ct_mult_rejects_limb_axis():
    params = tiny_pir_params(
        dbsize=10, bytes_per_item=8, dimensions=1, n=64,
        use_ciphertext_multiplication=True,
    )
    raw = generate_test_db(10, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    with pytest.raises(ValueError, match="limb"):
        PirServer(db, params, mesh=sharded.default_mesh(batch=1, limb=2))


def test_limb_mesh_rejects_bad_widths():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    mesh = sharded.default_mesh(batch=1, limb=4)  # L=2 not divisible by 4
    with pytest.raises(ValueError, match="must divide"):
        sharded.make_sharded_pipeline(db.ctx, params.dimensions, db.db_ntt, mesh)
    mesh2 = sharded.default_mesh(batch=1, limb=2)
    with pytest.raises(ValueError, match="reply_limbs"):
        sharded.make_sharded_pipeline(
            db.ctx, params.dimensions, db.db_ntt, mesh2, reply_limbs=1
        )


def test_sharded_with_shrunken_reply():
    params = tiny_pir_params(
        dbsize=30, bytes_per_item=8, dimensions=2, n=128, q_bits=(30, 30, 32)
    )
    raw = generate_test_db(30, params.bytes_per_item)
    db = PirDatabase.create(raw, params)
    client = PirClient.create(params, seed=5)
    mesh = sharded.default_mesh(batch=2)
    indices = [0, 29]
    queries = np.stack([client._create_query(i) for i in indices])
    gk = {e: jnp.asarray(k.data) for e, k in client.galois_keys.keys.items()}
    pipeline = sharded.make_sharded_pipeline(
        db.ctx, params.dimensions, db.db_ntt, mesh, reply_limbs=1
    )
    replies = np.asarray(pipeline(jnp.asarray(queries), gk))
    assert replies.shape[-2] == 1  # single limb crossed the wire

    from pir_tpu.proto import payload as pb

    resp = pb.Response()
    for qi in range(len(indices)):
        wire.save_ciphertexts(replies[qi], resp.reply.add())
    out = client.process_response(indices, resp)
    for i, idx in enumerate(indices):
        assert out[i] == raw[idx]
