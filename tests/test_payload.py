"""The hand-written payload.proto codec: golden bytes, byte equality with
the protobuf runtime, packed/unpacked dimensions, unknown fields and
truncated input."""

import pytest

from pir_tpu.proto import payload as pb


def _params(**kw):
    base = dict(
        num_items=1 << 20, dimensions=[162, 162],
        encryption_parameters=b"\x01\x02", num_pt=26244, bytes_per_item=288,
        items_per_plaintext=40, bits_per_coeff=23,
        use_ciphertext_multiplication=True, reencode_mode=1,
    )
    base.update(kw)
    return pb.PIRParameters(**base)


def _request():
    req = pb.Request()
    req.query.add().ct.extend([b"ab", b""])
    req.query.add()
    req.galois_keys = b"G" * 200
    req.relin_keys = b"R"
    return req


def _response():
    resp = pb.Response()
    resp.reply.add().ct.append(b"\x00" * 130)
    resp.reply.add().ct.extend([b"x", b"yz"])
    return resp


GOLDEN = [
    (pb.Ciphertexts(ct=[b"ab", b""]), b"\x0a\x02ab\x0a\x00"),
    (
        _request(),
        b"\x0a\x06\x0a\x02ab\x0a\x00" + b"\x0a\x00"
        + b"\x12\xc8\x01" + b"G" * 200 + b"\x1a\x01R",
    ),
    (
        _response(),
        b"\x0a\x85\x01\x0a\x82\x01" + b"\x00" * 130
        + b"\x0a\x07\x0a\x01x\x0a\x02yz",
    ),
    (
        _params(),
        b"\x08\x80\x80\x40" + b"\x12\x04\xa2\x01\xa2\x01"
        + b"\x1a\x02\x01\x02" + b"\x20\x84\xcd\x01" + b"\x28\xa0\x02"
        + b"\x30\x28" + b"\x38\x17" + b"\x40\x01" + b"\x48\x01",
    ),
]


@pytest.mark.parametrize("msg,blob", GOLDEN, ids=lambda v: type(v).__name__)
def test_golden_bytes_and_roundtrip(msg, blob):
    assert msg.SerializeToString() == blob
    back = type(msg)()
    assert back.ParseFromString(blob) == len(blob)
    assert back == msg
    assert back.SerializeToString() == blob


def test_defaults_are_omitted():
    assert pb.PIRParameters().SerializeToString() == b""
    assert pb.Request(galois_keys=b"", relin_keys=b"").SerializeToString() == b""
    assert _params(reencode_mode=0, use_ciphertext_multiplication=False,
                   bits_per_coeff=0).SerializeToString().endswith(b"\x30\x28")


def test_unpacked_dimensions_parse():
    msg = pb.PIRParameters.FromString(b"\x10\xa2\x01\x10\x05\x12\x01\x07")
    assert msg.dimensions == [162, 5, 7]


def test_reference_params_without_field_9_parse_with_mode_0():
    blob = _params(reencode_mode=0).SerializeToString()
    assert b"\x48" not in blob[-2:]
    msg = pb.PIRParameters.FromString(blob)
    assert msg.reencode_mode == 0 and msg.num_pt == 26244


@pytest.mark.parametrize(
    "unknown",
    [
        b"\x50\x96\x01",  # field 10, varint
        b"\x59" + b"\x00" * 8,  # field 11, fixed64
        b"\x62\x03abc",  # field 12, length-delimited
        b"\x6d" + b"\x00" * 4,  # field 13, fixed32
        b"\x73\x08\x01\x74",  # field 14, group holding a varint
        b"\x18\x05",  # known field 3 (bytes) with the varint wire type
    ],
)
def test_unknown_fields_are_skipped(unknown):
    blob = _params().SerializeToString()
    msg = pb.PIRParameters.FromString(unknown + blob)
    assert msg == _params()


@pytest.mark.parametrize("cut", [1, 3, 9, 20, -1])
def test_truncated_input_raises(cut):
    blob = _request().SerializeToString()
    with pytest.raises(pb.DecodeError):
        pb.Request.FromString(blob[:cut])


@pytest.mark.parametrize(
    "bad", [b"\x08" + b"\xff" * 11, b"\x07\x00", b"\x00\x01", b"\x73\x0c"]
)
def test_malformed_input_raises(bad):
    with pytest.raises(pb.DecodeError):
        pb.PIRParameters.FromString(bad)


def test_out_of_range_values_refused():
    with pytest.raises(ValueError):
        pb.PIRParameters(bytes_per_item=1 << 32).SerializeToString()
    with pytest.raises(ValueError):
        pb.PIRParameters(dimensions=[-1]).SerializeToString()


def test_repeated_message_add_and_delete():
    req = _request()
    del req.query[0].ct[:]
    assert req.query[0].ct == [] and len(req.query) == 2
    assert pb.Request.FromString(req.SerializeToString()) == req


# ---------------------------------------------------------------------------
# byte equality with the protobuf runtime, where it is installed
# ---------------------------------------------------------------------------


def _protobuf_classes():
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    F = descriptor_pb2.FieldDescriptorProto
    fdp = descriptor_pb2.FileDescriptorProto(
        name="payload_check.proto", package="pir_check", syntax="proto3"
    )

    def message(name, *fields):
        m = fdp.message_type.add(name=name)
        for number, fname, ftype, label, type_name in fields:
            f = m.field.add(name=fname, number=number, type=ftype, label=label)
            if type_name:
                f.type_name = type_name

    opt, rep = F.LABEL_OPTIONAL, F.LABEL_REPEATED
    message("Ciphertexts", (1, "ct", F.TYPE_BYTES, rep, None))
    message(
        "Request",
        (1, "query", F.TYPE_MESSAGE, rep, ".pir_check.Ciphertexts"),
        (2, "galois_keys", F.TYPE_BYTES, opt, None),
        (3, "relin_keys", F.TYPE_BYTES, opt, None),
    )
    message(
        "Response",
        (1, "reply", F.TYPE_MESSAGE, rep, ".pir_check.Ciphertexts"),
    )
    message(
        "PIRParameters",
        (1, "num_items", F.TYPE_UINT64, opt, None),
        (2, "dimensions", F.TYPE_UINT32, rep, None),
        (3, "encryption_parameters", F.TYPE_BYTES, opt, None),
        (4, "num_pt", F.TYPE_UINT64, opt, None),
        (5, "bytes_per_item", F.TYPE_UINT32, opt, None),
        (6, "items_per_plaintext", F.TYPE_UINT32, opt, None),
        (7, "bits_per_coeff", F.TYPE_UINT32, opt, None),
        (8, "use_ciphertext_multiplication", F.TYPE_BOOL, opt, None),
        (9, "reencode_mode", F.TYPE_UINT32, opt, None),
    )
    pool = descriptor_pool.DescriptorPool()
    pool.AddSerializedFile(fdp.SerializeToString())
    return {
        name: message_factory.GetMessageClass(
            pool.FindMessageTypeByName(f"pir_check.{name}")
        )
        for name in ("Ciphertexts", "Request", "Response", "PIRParameters")
    }


@pytest.mark.parametrize(
    "msg",
    [m for m, _ in GOLDEN] + [
        _params(num_items=(1 << 64) - 1, dimensions=[], bits_per_coeff=0),
        pb.Response(),
    ],
    ids=lambda v: type(v).__name__,
)
def test_matches_protobuf_runtime(msg):
    cls = _protobuf_classes()[type(msg).__name__]
    blob = msg.SerializeToString()
    ref = cls.FromString(blob)
    assert ref.SerializeToString() == blob
    assert type(msg).FromString(ref.SerializeToString()) == msg


def test_server_imports_without_protobuf():
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['google'] = None; "
        "sys.modules['google.protobuf'] = None; "
        "import pir_tpu.pir.server, pir_tpu.pir.client; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
