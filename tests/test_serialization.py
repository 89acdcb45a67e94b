"""Wire codec roundtrips — parity with serialization_test.cpp:61-175."""

import numpy as np
import pytest

from pir_tpu.core.params import generate_encryption_params
from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.proto import payload as pb
from pir_tpu.testing.fixtures import generate_test_db, make_toolkit
from pir_tpu.testing.params import tiny_pir_params


def test_array_roundtrip(rng):
    a = rng.integers(0, 1 << 60, size=(2, 3, 8), dtype=np.uint64)
    assert (wire.unpack_array(wire.pack_array(a)) == a).all()


def test_array_bad_magic():
    with pytest.raises(ValueError):
        wire.unpack_array(b"XXXX" + b"\0" * 32)


def test_ciphertexts_roundtrip(rng):
    cts = rng.integers(0, 1 << 50, size=(3, 2, 2, 16), dtype=np.uint64)
    msg = wire.save_ciphertexts(cts)
    assert len(msg.ct) == 3
    assert (wire.load_ciphertexts(msg) == cts).all()


def test_galois_keys_roundtrip():
    tk = make_toolkit(tiny_pir_params(n=64))
    blob = wire.serialize_galois_keys(tk.galois)
    back = wire.deserialize_galois_keys(blob)
    assert set(back.keys) == set(tk.galois.keys)
    for e in tk.galois.keys:
        assert (np.asarray(back[e].data) == np.asarray(tk.galois[e].data)).all()


def test_relin_keys_roundtrip():
    tk = make_toolkit(tiny_pir_params(n=64))
    blob = wire.serialize_relin_keys(tk.relin)
    back = wire.deserialize_relin_keys(blob)
    assert (np.asarray(back.key.data) == np.asarray(tk.relin.key.data)).all()


def test_encryption_params_roundtrip():
    ep = generate_encryption_params(4096, 20)
    assert wire.deserialize_encryption_params(
        wire.serialize_encryption_params(ep)
    ) == ep
    with pytest.raises(ValueError):
        wire.deserialize_encryption_params(b"JUNK...")


def test_pir_params_proto_roundtrip():
    p = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2)
    msg = wire.pir_params_to_proto(p)
    blob = msg.SerializeToString()
    msg2 = pb.PIRParameters()
    msg2.ParseFromString(blob)
    assert wire.pir_params_from_proto(msg2) == p


def test_request_proto_shape():
    p = tiny_pir_params(dbsize=10, bytes_per_item=8, n=64)
    client = PirClient.create(p, seed=1)
    req = client.create_request([0, 5])
    blob = req.SerializeToString()
    req2 = pb.Request()
    req2.ParseFromString(blob)
    assert len(req2.query) == 2
    assert req2.galois_keys and req2.relin_keys
    cts = wire.load_ciphertexts(req2.query[0])
    assert cts.shape[1:] == (2, client.ctx.L, client.ctx.n)


def test_database_checkpoint_roundtrip(tmp_path):
    p = tiny_pir_params(dbsize=10, bytes_per_item=8, n=64)
    raw = generate_test_db(10, 8)
    db = PirDatabase.create(raw, p)
    path = tmp_path / "db.npz"
    db.save(path)
    db2 = PirDatabase.load(path, p)
    assert (np.asarray(db2.db_ntt) == np.asarray(db.db_ntt)).all()
    assert (db2.db_pts == db.db_pts).all()
    with pytest.raises(ValueError):
        PirDatabase.load(path, tiny_pir_params(dbsize=11, bytes_per_item=8, n=64))
