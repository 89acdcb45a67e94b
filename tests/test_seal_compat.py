"""SEAL 3.5 stream codec: self-consistency + structure (see module caveat)."""

import struct

import numpy as np
import pytest

from pir_tpu.core.params import generate_encryption_params
from pir_tpu.pir import seal_compat, wire
from pir_tpu.testing.params import tiny_encryption_params


def test_roundtrip_default_params():
    ep = generate_encryption_params(4096, 20)
    blob = seal_compat.save_encryption_params(ep)
    assert seal_compat.load_encryption_params(blob) == ep


def test_header_structure():
    ep = generate_encryption_params(4096, 20)
    blob = seal_compat.save_encryption_params(ep)
    hdr = seal_compat.parse_header(blob)
    assert hdr["version"] == (3, 5)
    assert hdr["size"] == len(blob)
    # payload: scheme=BFV, degree, 3 moduli, plain modulus
    assert struct.unpack_from("<B", blob, 16)[0] == seal_compat.SCHEME_BFV
    assert struct.unpack_from("<Q", blob, 17)[0] == 4096
    assert struct.unpack_from("<Q", blob, 25)[0] == 3


def test_bad_magic_rejected():
    with pytest.raises(ValueError):
        seal_compat.parse_header(b"\x00" * 32)
    assert not seal_compat.looks_like_seal_stream(b"PTPE{}")


def test_compressed_stream_rejected():
    ep = generate_encryption_params(4096, 20)
    blob = bytearray(seal_compat.save_encryption_params(ep))
    blob[5] = 1  # compr_mode = deflate
    with pytest.raises(ValueError, match="compressed"):
        seal_compat.parse_header(bytes(blob))


def test_wire_accepts_both_encodings():
    ep = generate_encryption_params(4096, 20)
    native = wire.serialize_encryption_params(ep)
    seal = seal_compat.save_encryption_params(ep)
    assert wire.deserialize_encryption_params_any(native) == ep
    assert wire.deserialize_encryption_params_any(seal) == ep
    with pytest.raises(ValueError):
        wire.deserialize_encryption_params_any(b"garbage")


# ---------------------------------------------------------------------------
# blake2xb / parms_id
# ---------------------------------------------------------------------------


def test_pure_blake2b_matches_hashlib():
    """The raw-parameter-block BLAKE2b core vs hashlib with the standard
    sequential block (digest 64, fanout 1, depth 1) — validates the
    compression function on empty/short/multi-block inputs."""
    import hashlib

    seq = seal_compat._b2x_params(64, 1, 1, 0, 0, 0, 0, 0)
    for msg in (b"", b"abc", b"x" * 128, b"y" * 129, bytes(range(256)) * 3):
        assert seal_compat._blake2b_raw(msg, seq) == hashlib.blake2b(msg).digest()


def test_blake2xb_spec_properties():
    # deterministic, length-exact, and a prefix-free XOF (different output
    # lengths give unrelated streams, per the BLAKE2X design)
    a32 = seal_compat.blake2xb(b"abc", 32)
    assert len(a32) == 32
    assert a32 == seal_compat.blake2xb(b"abc", 32)
    a100 = seal_compat.blake2xb(b"abc", 100)
    assert len(a100) == 100
    assert a100[:32] != a32  # xof_length is part of the parameterization
    assert seal_compat.blake2xb(b"abd", 32) != a32
    with pytest.raises(ValueError):
        seal_compat.blake2xb(b"", 0)


def test_parms_id_distinguishes_params():
    a = seal_compat.parms_id_for(generate_encryption_params(4096, 20))
    b = seal_compat.parms_id_for(generate_encryption_params(4096, 24))
    c = seal_compat.parms_id_for(generate_encryption_params(8192, 20))
    assert len(a) == 4 and a != b and a != c and b != c


# ---------------------------------------------------------------------------
# ciphertext / kswitch-key streams
# ---------------------------------------------------------------------------


def _random_ct(ep, size=2, rng=None, limbs=None):
    rng = rng or np.random.default_rng(3)
    moduli = ep.coeff_modulus if limbs == "qp" else ep.ct_modulus
    return np.stack(
        [
            np.stack(
                [
                    rng.integers(0, q, ep.poly_modulus_degree, dtype=np.uint64)
                    for q in moduli
                ]
            )
            for _ in range(size)
        ]
    )


def test_ciphertext_stream_roundtrip():
    ep = tiny_encryption_params(n=64)
    ct = _random_ct(ep)
    blob = seal_compat.save_ciphertext(ct, ep)
    hdr = seal_compat.parse_header(blob)
    assert hdr["size"] == len(blob)
    out = seal_compat.load_ciphertext(blob, ep)
    assert np.array_equal(out, ct)


def test_ciphertext_stream_wrong_params_rejected():
    ep = tiny_encryption_params(n=64)
    other = tiny_encryption_params(n=128)
    blob = seal_compat.save_ciphertext(_random_ct(ep), ep)
    with pytest.raises(ValueError, match="degree|parms_id"):
        seal_compat.load_ciphertext(blob, other)


def test_ntt_form_ciphertext_rejected_on_wire():
    ep = tiny_encryption_params(n=64)
    blob = seal_compat.save_ciphertext(_random_ct(ep), ep, is_ntt_form=True)
    with pytest.raises(ValueError, match="NTT"):
        seal_compat.load_ciphertext(blob, ep)


def test_wire_load_ciphertexts_accepts_seal_stream():
    from pir_tpu.core.params import create_pir_parameters
    from pir_tpu.core.context import PirContext
    from pir_tpu.proto import payload as pb

    ep = tiny_encryption_params(n=64)
    params = create_pir_parameters(10, 8, 1, ep)
    ctx = PirContext(params)
    ct = _random_ct(ep)
    msg = pb.Ciphertexts()
    msg.ct.append(seal_compat.save_ciphertext(ct, ep))
    out = wire.load_ciphertexts(msg, ctx)
    assert np.array_equal(out[0], ct)
    with pytest.raises(ValueError, match="context"):
        wire.load_ciphertexts(msg)


def test_kswitch_keys_roundtrip_with_galois_rows():
    ep = tiny_encryption_params(n=64)
    rng = np.random.default_rng(5)
    # two galois elements with [L, 2, Lp, N] key data, as bfv/keys packs them
    L = len(ep.ct_modulus)
    keys = {
        33: np.stack([_random_ct(ep, 2, rng, "qp") for _ in range(L)]),
        5: np.stack([_random_ct(ep, 2, rng, "qp") for _ in range(L)]),
    }
    rows = seal_compat.galois_rows_from_dict(keys, ep.poly_modulus_degree)
    assert len(rows) == (33 - 1) // 2 + 1
    blob = seal_compat.save_kswitch_keys(rows, ep)
    back = seal_compat.galois_dict_from_rows(
        seal_compat.load_kswitch_keys(blob, ep)
    )
    assert set(back) == {5, 33}
    for e in (5, 33):
        assert np.array_equal(back[e], keys[e])


def test_galois_rows_validate_elements():
    ep = tiny_encryption_params(n=64)
    with pytest.raises(ValueError, match="galois element"):
        seal_compat.galois_rows_from_dict({4: np.zeros((1, 2, 3, 64))}, 64)
    assert seal_compat.galois_rows_from_dict({}, 64) == []


# ---------------------------------------------------------------------------
# Hand-derived byte goldens — the layout contract of SEAL_STREAM.md frozen
# field by field, independent of the codec's own writer.
# ---------------------------------------------------------------------------


def _hdr(total: int) -> bytes:
    return struct.pack("<HBBBBHQ", 0xA15E, 0x10, 3, 5, 0, 0, total)


def test_encryption_params_byte_golden():
    ep = tiny_encryption_params(n=64)
    # hand-assemble: header | scheme | degree | count | SmallModulus
    # streams (nested 24-byte each) | plain SmallModulus stream
    body = struct.pack("<B", 1) + struct.pack("<QQ", 64, 3)
    for m in ep.coeff_modulus:
        body += _hdr(24) + struct.pack("<Q", m)
    body += _hdr(24) + struct.pack("<Q", ep.plain_modulus)
    expected = _hdr(16 + len(body)) + body
    assert seal_compat.save_encryption_params(ep) == expected
    assert seal_compat.load_encryption_params(expected) == ep


def test_ciphertext_byte_golden():
    ep = tiny_encryption_params(n=64)
    L, n = len(ep.coeff_modulus), 64
    rng = np.random.default_rng(3)
    ct = np.stack(
        [
            np.stack(
                [rng.integers(0, q, n, dtype=np.uint64) for q in ep.coeff_modulus]
            )
            for _ in range(2)
        ]
    )
    words = 2 * L * n
    # hand-assemble: header | parms_id | is_ntt | size | degree |
    # coeff_mod_count | scale 1.0 double | IntArray stream (header |
    # word count | words)
    arr = _hdr(16 + 8 + 8 * words) + struct.pack("<Q", words)
    arr += ct.astype("<u8").tobytes()
    body = struct.pack("<4Q", *seal_compat.parms_id_for(ep, L))
    body += struct.pack("<B", 0)
    body += struct.pack("<QQQ", 2, n, L)
    body += struct.pack("<d", 1.0)
    body += arr
    expected = _hdr(16 + len(body)) + body
    assert seal_compat.save_ciphertext(ct, ep) == expected
    assert np.array_equal(seal_compat.load_ciphertext(expected, ep), ct)


# ---------------------------------------------------------------------------
# Loader hardening: malformed length fields must raise, never crash or
# over-read (serialization.cpp:32-55 status-checked loader parity).
# ---------------------------------------------------------------------------


def _valid_ct_blob():
    ep = tiny_encryption_params(n=64)
    return ep, seal_compat.save_ciphertext(_random_ct(ep), ep)


def test_ciphertext_oversized_header_size_rejected():
    ep, blob = _valid_ct_blob()
    bad = bytearray(blob)
    struct.pack_into("<Q", bad, 8, len(blob) + 1000)  # header size lies
    with pytest.raises(ValueError, match="more bytes than present"):
        seal_compat.load_ciphertext(bytes(bad), ep)


def test_ciphertext_bad_word_count_rejected():
    ep, blob = _valid_ct_blob()
    bad = bytearray(blob)
    # IntArray word count at header(16) + parms_id(32) + 1 + 24 + 8 + 16
    struct.pack_into("<Q", bad, 16 + 32 + 1 + 24 + 8 + 16, 1 << 40)
    with pytest.raises(ValueError, match="length mismatch|exceeds"):
        seal_compat.load_ciphertext(bytes(bad), ep)


def test_ciphertext_bad_scale_rejected():
    ep, blob = _valid_ct_blob()
    bad = bytearray(blob)
    struct.pack_into("<d", bad, 16 + 32 + 1 + 24, 2.0)
    with pytest.raises(ValueError, match="scale"):
        seal_compat.load_ciphertext(bytes(bad), ep)


def test_seeded_ciphertext_expands_deterministically():
    """A marker+seed c1 slot expands via the SEAL stream PRNG on load."""
    ep = tiny_encryption_params(n=64)
    ct = _random_ct(ep)
    seed = tuple(range(1, 9))
    flat1 = ct[1].reshape(-1)
    flat1[:] = 0
    flat1[0] = np.uint64(seal_compat.SEED_MARKER)
    flat1[1:9] = np.array(seed, dtype=np.uint64)
    blob = seal_compat.save_ciphertext(ct, ep)
    got = seal_compat.load_ciphertext(blob, ep)
    L, n = ct.shape[1], ct.shape[2]
    expect = seal_compat.sample_poly_uniform(seed, ep.coeff_modulus[:L], n)
    assert (got[0] == ct[0]).all()
    assert (got[1] == expect).all()
    # and twice gives the same expansion (pure function of the seed)
    again = seal_compat.load_ciphertext(blob, ep)
    assert (again == got).all()


def test_seeded_emit_accept_roundtrip_kswitch():
    """Keys generated with seeded_wire serialize seeded and load back to
    the exact same arrays as their full-form serialization."""
    from pir_tpu.bfv import keys as keys_mod
    from pir_tpu.core.context import PirContext
    from pir_tpu.testing.params import tiny_pir_params

    params = tiny_pir_params(n=64, t_bits=12)
    ctx = PirContext(params)
    ep = params.encryption_params
    rng = np.random.default_rng(9)
    sk = keys_mod.gen_secret_key(ctx, rng)
    gk = keys_mod.gen_galois_keys(ctx, sk, [65, 33], rng, seeded_wire=True)
    for key in gk.keys.values():
        assert key.seeds is not None and len(key.seeds) == ctx.L
    rows = seal_compat.galois_rows_from_dict(gk.keys, 64)
    seeds = seal_compat.galois_seed_rows(gk.keys, 64)
    blob_seeded = seal_compat.save_kswitch_keys(rows, ep, seeds=seeds)
    blob_full = seal_compat.save_kswitch_keys(rows, ep)
    assert blob_seeded != blob_full  # seeded form differs on the wire
    # the seeded stream visibly carries the marker word
    assert struct.pack("<Q", seal_compat.SEED_MARKER) in blob_seeded
    got_seeded = seal_compat.load_kswitch_keys(blob_seeded, ep)
    got_full = seal_compat.load_kswitch_keys(blob_full, ep)
    assert len(got_seeded) == len(got_full)
    for rs, rf in zip(got_seeded, got_full):
        assert len(rs) == len(rf)
        for a, b in zip(rs, rf):
            assert (a == b).all()


def test_seeded_keys_without_seeds_not_marked():
    """Keys generated without seeded_wire have no seeds and serialize in
    full form (galois_seed_rows returns None)."""
    from pir_tpu.bfv import keys as keys_mod
    from pir_tpu.core.context import PirContext
    from pir_tpu.testing.params import tiny_pir_params

    params = tiny_pir_params(n=64, t_bits=12)
    ctx = PirContext(params)
    rng = np.random.default_rng(9)
    sk = keys_mod.gen_secret_key(ctx, rng)
    gk = keys_mod.gen_galois_keys(ctx, sk, [65], rng)
    assert seal_compat.galois_seed_rows(gk.keys, 64) is None


def test_blake2xb_keyed_matches_hashlib_root():
    """The keyed BLAKE2b core (the PRNG's root hash) against hashlib."""
    import hashlib

    key = bytes(range(64))
    msg = b"some message bytes"
    mine = seal_compat._blake2b_raw(
        key + b"\x00" * 64 + msg,
        seal_compat._b2x_params(64, 1, 1, 0, 0, 0, 0, 0, key_length=64),
    )
    assert mine == hashlib.blake2b(msg, digest_size=64, key=key).digest()


def test_blake2xb_vectorized_output_blocks():
    """The numpy-vectorized XOF output stage equals the scalar path."""
    for out_len in (64, 200, 4096):
        h0 = seal_compat._blake2b_raw(
            b"x", seal_compat._b2x_params(64, 1, 1, 0, 0, out_len, 0, 0)
        )
        scalar = b""
        i = 0
        while len(scalar) < out_len:
            take = min(64, out_len - len(scalar))
            scalar += seal_compat._blake2b_raw(
                h0, seal_compat._b2x_params(take, 0, 0, 64, i, out_len, 0, 64)
            )[:take]
            i += 1
        assert seal_compat.blake2xb(b"x", out_len) == scalar


def test_kswitch_bad_nested_length_rejected():
    ep = tiny_encryption_params(n=64)
    rng = np.random.default_rng(5)
    Lp, n = len(ep.coeff_modulus), 64
    row = [
        np.stack(
            [
                np.stack(
                    [rng.integers(0, q, n, dtype=np.uint64) for q in ep.coeff_modulus]
                )
                for _ in range(2)
            ]
        )
    ]
    blob = seal_compat.save_kswitch_keys([row], ep)
    loaded = seal_compat.load_kswitch_keys(blob, ep)
    assert len(loaded) == 1 and np.array_equal(loaded[0][0], row[0])
    bad = bytearray(blob)
    # row-count field right after header + parms_id
    struct.pack_into("<Q", bad, 16 + 32, 1 << 50)
    with pytest.raises(ValueError, match="implausible"):
        seal_compat.load_kswitch_keys(bytes(bad), ep)
    bad2 = bytearray(blob)
    # per-row ciphertext count (right after header + parms_id + row count)
    struct.pack_into("<Q", bad2, 16 + 32 + 8, 1 << 20)
    with pytest.raises(ValueError, match="implausible|truncated|exceeds"):
        seal_compat.load_kswitch_keys(bytes(bad2), ep)


def _deflate_stream(blob: bytes, raw: bool = False) -> bytes:
    """Recompress a none-mode stream as SEAL's deflate mode."""
    import zlib

    body = blob[16:]
    if raw:
        c = zlib.compressobj(wbits=-15)
        comp = c.compress(body) + c.flush()
    else:
        comp = zlib.compress(body)
    hdr = bytearray(blob[:16])
    hdr[5] = 1  # compr_mode deflate
    struct.pack_into("<Q", hdr, 8, 16 + len(comp))
    return bytes(hdr) + comp


@pytest.mark.parametrize("raw", [False, True])
def test_deflate_streams_accepted(raw):
    """SEAL 3.5 defaults to deflate when zlib is available — loaders
    accept compressed top-level streams (both zlib-wrapper and raw
    deflate bodies); emit stays uncompressed (SEAL loads either)."""
    ep = tiny_encryption_params(n=64)
    # encryption parameters
    blob = seal_compat.save_encryption_params(ep)
    assert seal_compat.load_encryption_params(_deflate_stream(blob, raw)) == ep
    # ciphertext
    ct = _random_ct(ep)
    cblob = seal_compat.save_ciphertext(ct, ep)
    assert np.array_equal(
        seal_compat.load_ciphertext(_deflate_stream(cblob, raw), ep), ct
    )


def test_garbage_deflate_rejected():
    ep = tiny_encryption_params(n=64)
    blob = bytearray(seal_compat.save_ciphertext(_random_ct(ep), ep))
    blob[5] = 1  # claims deflate; body is uncompressed garbage to zlib
    with pytest.raises(ValueError, match="deflate"):
        seal_compat.load_ciphertext(bytes(blob), ep)
