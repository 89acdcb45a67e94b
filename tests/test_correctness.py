"""Full-protocol integration: client → server → client roundtrip.

The acceptance suite — parity with the reference's correctness_test.cpp
matrix (:95-113), decomposition mode (ciphertext-multiplication mode lands
with the BFV ct×ct multiply).  Small-ring entries keep the suite fast;
the N=4096 default-parameter entries run the exact reference configs.
"""

import numpy as np
import pytest

from pir_tpu.core.params import create_pir_parameters, generate_encryption_params
from pir_tpu.pir.client import PirClient
from pir_tpu.pir.database import PirDatabase
from pir_tpu.pir.server import PirServer
from pir_tpu.testing.fixtures import generate_test_db
from pir_tpu.testing.params import tiny_pir_params


def _roundtrip_params(dbsize, elem, d, n, t_bits, bpc, use_ct_mult):
    return tiny_pir_params(
        dbsize=dbsize,
        bytes_per_item=elem,
        dimensions=d,
        n=n,
        t_bits=t_bits,
        bits_per_coeff=bpc,
        use_ciphertext_multiplication=use_ct_mult,
    )


def _roundtrip(params, desired_indices, seed=42, wire_format="native"):
    raw = generate_test_db(params.num_items, params.bytes_per_item, seed)
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=7, wire_format=wire_format)
    server = PirServer.create(db, params)

    request = client.create_request(desired_indices)
    response = server.process_request(request)
    results = client.process_response(desired_indices, response)

    assert len(results) == len(desired_indices)
    for i, idx in enumerate(desired_indices):
        assert results[i] == raw[idx], f"index {idx}"


TINY_MATRIX = [
    # (dbsize, elem, d, n, t_bits, bits_per_coeff, indices)
    (10, 8, 1, 64, 12, 0, [0]),
    (10, 8, 1, 64, 12, 0, [9, 3]),
    (30, 8, 2, 64, 12, 0, [1, 5]),
    (30, 8, 2, 64, 12, 6, [9, 25]),
    (64, 8, 3, 64, 12, 0, [0, 33, 63]),
    (500, 16, 2, 128, 13, 0, [9, 125, 499]),
    (90, 88, 1, 64, 12, 0, [0, 80, 89]),  # one item per plaintext, dim_sum > N
]


@pytest.mark.parametrize("dbsize,elem,d,n,t_bits,bpc,indices", TINY_MATRIX)
def test_roundtrip_tiny(dbsize, elem, d, n, t_bits, bpc, indices):
    params = tiny_pir_params(
        dbsize=dbsize,
        bytes_per_item=elem,
        dimensions=d,
        n=n,
        t_bits=t_bits,
        bits_per_coeff=bpc,
    )
    _roundtrip(params, indices)


# ct-mult recursion depth matches the reference's coverage (d <= 2:
# each extra dimension costs a full ct×ct multiply's noise).
CT_MULT_TINY_MATRIX = [
    # (dbsize, elem, d, n, t_bits, bpc, indices)
    (10, 8, 1, 64, 12, 0, [0, 9]),
    (30, 8, 2, 64, 12, 0, [1, 29]),
    (30, 8, 2, 64, 12, 6, [9, 25]),
]


@pytest.mark.parametrize("dbsize,elem,d,n,t_bits,bpc,indices", CT_MULT_TINY_MATRIX)
def test_roundtrip_tiny_ct_mult(dbsize, elem, d, n, t_bits, bpc, indices):
    params = _roundtrip_params(dbsize, elem, d, n, t_bits, bpc, True)
    _roundtrip(params, indices)


# Reference-config entries — the complete 11-tuple matrix of
# correctness_test.cpp:95-113, both modes, transcribed verbatim.
REFERENCE_MATRIX = [
    # (use_ct_mult, poly_degree, plain_bits, elem, bpc, dbsize, d, indices)
    (False, 4096, 24, 0, 0, 10, 1, [0]),
    (False, 4096, 24, 0, 10, 9, 2, [1, 5]),
    (False, 4096, 24, 0, 6, 500, 2, [9, 125]),
    (False, 4096, 24, 64, 10, 1200, 1, [0, 80, 81, 123, 777, 1199]),
    (False, 4096, 24, 289, 10, 1200, 1, [0, 47, 777, 1199]),
    (True, 4096, 24, 0, 0, 10, 1, [0]),
    (True, 4096, 16, 0, 10, 9, 2, [1, 5]),
    (True, 4096, 16, 0, 6, 500, 2, [9, 125]),
    (True, 4096, 16, 64, 10, 1200, 1, [0, 80, 81, 123, 777, 1199]),
    (True, 4096, 16, 289, 10, 1200, 1, [0, 47, 777, 1199]),
    (True, 8192, 42, 0, 0, 87, 2, [5, 33, 86]),
]


@pytest.mark.slow
@pytest.mark.parametrize(
    "ct_mult,n,t_bits,elem,bpc,dbsize,d,indices", REFERENCE_MATRIX
)
def test_roundtrip_reference_configs(
    ct_mult, n, t_bits, elem, bpc, dbsize, d, indices
):
    params = create_pir_parameters(
        dbsize,
        elem,
        d,
        generate_encryption_params(n, t_bits),
        use_ciphertext_multiplication=ct_mult,
        bits_per_coeff=bpc,
    )
    if elem == 0:
        # whole-plaintext items: retrieval compares against the encoded bytes
        raw = generate_test_db(dbsize, params.bytes_per_item, 42)
        db = PirDatabase.create(raw, params)
        client = PirClient.create(params, seed=7)
        server = PirServer.create(db, params)
        request = client.create_request(indices)
        response = server.process_request(request)
        results = client.process_response(indices, response)
        for i, idx in enumerate(indices):
            assert results[i] == raw[idx]
    else:
        _roundtrip(params, indices)


# Sub-32-bit parameter profile (primes.tpu_coeff_modulus): single-u32
# residues.  The benchmark-shaped configs of the reference matrix, decomp
# mode.
TPU32_MATRIX = [
    # (n, t_bits, elem, bpc, dbsize, d, indices)
    (4096, 24, 288, 0, 500, 2, [9, 125, 499]),
    (4096, 24, 64, 10, 1200, 1, [0, 777, 1199]),
    (8192, 24, 0, 0, 87, 2, [5, 33, 86]),
]


@pytest.mark.slow
@pytest.mark.parametrize("n,t_bits,elem,bpc,dbsize,d,indices", TPU32_MATRIX)
def test_roundtrip_tpu32_profile(n, t_bits, elem, bpc, dbsize, d, indices):
    params = create_pir_parameters(
        dbsize,
        elem,
        d,
        generate_encryption_params(n, t_bits, profile="tpu32"),
        bits_per_coeff=bpc,
    )
    assert all(
        q.bit_length() <= 32
        for q in params.encryption_params.coeff_modulus
    )
    if elem == 0:
        raw = generate_test_db(dbsize, params.bytes_per_item, 42)
        db = PirDatabase.create(raw, params)
        client = PirClient.create(params, seed=7)
        server = PirServer.create(db, params)
        response = server.process_request(client.create_request(indices))
        results = client.process_response(indices, response)
        for i, idx in enumerate(indices):
            assert results[i] == raw[idx]
    else:
        _roundtrip(params, indices)


@pytest.mark.parametrize("dbsize,elem,d,n,t_bits,bpc,indices", TINY_MATRIX)
def test_roundtrip_tiny_seal_wire(dbsize, elem, d, n, t_bits, bpc, indices):
    """The tiny matrix again with every wire byte a SEAL 3.5 stream."""
    params = tiny_pir_params(
        dbsize=dbsize,
        bytes_per_item=elem,
        dimensions=d,
        n=n,
        t_bits=t_bits,
        bits_per_coeff=bpc,
        reencode_digits="legacy",
    )
    _roundtrip(params, indices, wire_format="seal")


def test_batched_queries_one_request():
    params = tiny_pir_params(dbsize=30, bytes_per_item=8, dimensions=2, n=64)
    _roundtrip(params, [0, 7, 15, 29])


def test_all_indices_small_db():
    params = tiny_pir_params(dbsize=12, bytes_per_item=8, dimensions=1, n=64)
    _roundtrip(params, list(range(12)))
