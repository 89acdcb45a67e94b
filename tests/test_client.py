"""Client query structure — parity with client_test.cpp: decrypt generated
queries and assert the exact one-hot structure with m⁻¹ scaling."""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.bfv import encrypt as enc_mod
from pir_tpu.pir import wire
from pir_tpu.pir.client import PirClient
from pir_tpu.testing.params import tiny_pir_params
from pir_tpu.utils.math import invert_mod, next_power_two


def _decrypt_query(client, query_cts):
    return [
        enc_mod.decrypt(client.ctx, client.sk, jnp.asarray(query_cts[i]))
        for i in range(query_cts.shape[0])
    ]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_query_structure(d):
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=d, n=64)
    client = PirClient.create(params, seed=3)
    dim_sum = params.dimensions_sum
    index = 17
    req = client.create_request([index])
    assert len(req.query) == 1
    cts = wire.load_ciphertexts(req.query[0])
    assert cts.shape[0] == dim_sum // 64 + 1

    pts = _decrypt_query(client, cts)
    flat = np.concatenate(pts)[:dim_sum]
    indices = client.db.calculate_indices(index)
    m_inv = invert_mod(next_power_two(dim_sum % 64), client.ctx.t)
    expected = np.zeros(dim_sum, dtype=np.uint64)
    off = 0
    for dim, hot in zip(params.dimensions, indices):
        expected[off + hot] = m_inv
        off += dim
    assert (flat == expected).all()


def test_query_multi_ct_spill():
    """dim_sum > N forces the one-hots across several ciphertexts
    (client_test.cpp:169-267 role)."""
    params = tiny_pir_params(dbsize=5000, bytes_per_item=88, dimensions=1, n=64)
    assert params.dimensions_sum > 64
    client = PirClient.create(params, seed=3)
    index = 4321
    req = client.create_request([index])
    cts = wire.load_ciphertexts(req.query[0])
    dim_sum = params.dimensions_sum
    assert cts.shape[0] == dim_sum // 64 + 1

    pts = _decrypt_query(client, cts)
    pt_index = index // params.items_per_plaintext
    ct_idx, pos = pt_index // 64, pt_index % 64
    num_cts = cts.shape[0]
    m = 64 if ct_idx < num_cts - 1 else next_power_two(dim_sum % 64)
    for c in range(num_cts):
        expect = np.zeros(64, dtype=np.uint64)
        if c == ct_idx:
            expect[pos] = invert_mod(m, client.ctx.t)
        assert (pts[c] == expect).all(), c


def test_invalid_index_rejected():
    params = tiny_pir_params(dbsize=10, bytes_per_item=8, n=64)
    client = PirClient.create(params, seed=3)
    with pytest.raises(ValueError):
        client.create_request([10])


def test_response_count_mismatch_rejected():
    from pir_tpu.proto import payload as pb

    params = tiny_pir_params(dbsize=10, bytes_per_item=8, n=64)
    client = PirClient.create(params, seed=3)
    with pytest.raises(ValueError):
        client.process_response([0, 1], pb.Response())


def test_process_reply_synthetic_decomposition():
    """Client reply processing against synthetically decomposed replies —
    the client_test.cpp:350-515 pattern: server-side scan is bypassed; the
    reply is hand-built by decomposing an encryption of the target."""
    import jax.numpy as jnp
    from pir_tpu.bfv import encrypt as enc_mod
    from pir_tpu.ops import decompose
    from pir_tpu.proto import payload as pb

    for d in (1, 2, 3):
        params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=d, n=64)
        client = PirClient.create(params, seed=11)
        ctx = client.ctx
        target = np.arange(ctx.n, dtype=np.uint64) % ctx.t
        ct = enc_mod.encrypt(ctx, client.pk, target, client._rng)

        # build the reply the way the server's decomposition recursion would:
        # (d-1) rounds of decompose, innermost first
        cts = [np.asarray(ct)]
        for _ in range(d - 1):
            nxt = []
            for c in cts:
                pts = np.asarray(decompose.decompose_ct(ctx, jnp.asarray(c)))
                for k in range(pts.shape[0]):
                    # encrypt each digit plaintext (sv x digit with sv = Enc(1))
                    nxt.append(
                        np.asarray(enc_mod.encrypt(ctx, client.pk, pts[k], client._rng))
                    )
            cts = nxt
        er2 = decompose.expansion_ratio(ctx) * 2
        assert len(cts) == er2 ** (d - 1)

        reply = pb.Ciphertexts()
        from pir_tpu.pir import wire as wire_mod

        wire_mod.save_ciphertexts(np.stack(cts), reply)
        got = client._process_reply(reply)
        assert (got == target).all(), d
