"""The four messages of ``payload.proto``, encoded without a protobuf runtime.

Byte-identical to protoc's proto3 output for this schema: fields are
written in field-number order, singular fields holding their default
value (0, False, empty bytes) are omitted, every element of a repeated
field is written, and ``repeated uint32 dimensions`` is packed.  Parsing
accepts the packed and the unpacked form of ``dimensions``, skips fields
it does not know (a reference ``PIRParameters`` without field 9 parses
with ``reencode_mode = 0``) and raises ``DecodeError`` on truncated or
malformed input.

The message classes expose what the code base uses of the generated API:
attributes named after the fields, list-valued repeated fields with
``add()`` on repeated messages, ``SerializeToString`` and
``ParseFromString``.
"""

from __future__ import annotations

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_U32 = (1 << 32) - 1
_U64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Truncated or malformed wire bytes."""


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _put_varint(out: bytearray, value: int) -> None:
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _get_varint(data, pos: int) -> tuple[int, int]:
    value = shift = 0
    for _ in range(10):
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & _U64, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _get_bytes(data, pos: int) -> tuple[bytes, int]:
    size, pos = _get_varint(data, pos)
    end = pos + size
    if end > len(data):
        raise DecodeError("truncated length-delimited field")
    return bytes(data[pos:end]), end


def _skip(data, pos: int, number: int, wire_type: int) -> int:
    """Position after one unknown field's payload."""
    if wire_type == _VARINT:
        return _get_varint(data, pos)[1]
    if wire_type in (_I64, _I32):
        end = pos + (8 if wire_type == _I64 else 4)
        if end > len(data):
            raise DecodeError("truncated fixed-width field")
        return end
    if wire_type == _LEN:
        return _get_bytes(data, pos)[1]
    if wire_type == _SGROUP:
        while True:
            key, pos = _get_varint(data, pos)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return pos
            pos = _skip(data, pos, key >> 3, key & 7)
    raise DecodeError(f"invalid wire type {wire_type}")


# ---------------------------------------------------------------------------
# schema-driven messages
# ---------------------------------------------------------------------------


class _RepeatedMessage(list):
    """A repeated message field: a list with protobuf's ``add()``."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self):
        msg = self._cls()
        self.append(msg)
        return msg


class _Message:
    # (field number, attribute name, kind[, message class]); kinds:
    # "uint64", "uint32", "bool", "bytes", "rep_bytes", "rep_uint32",
    # "rep_message"
    _FIELDS: tuple = ()

    def __init__(self, **values):
        self.Clear()
        for name, value in values.items():
            if name not in self._names():
                raise AttributeError(f"{type(self).__name__} has no field {name}")
            if isinstance(getattr(self, name), list):
                getattr(self, name).extend(value)
            else:
                setattr(self, name, value)

    @classmethod
    def _names(cls):
        return {f[1] for f in cls._FIELDS}

    def Clear(self) -> None:
        for field in self._FIELDS:
            _, name, kind = field[:3]
            if kind == "rep_message":
                setattr(self, name, _RepeatedMessage(field[3]))
            elif kind.startswith("rep_"):
                setattr(self, name, [])
            else:
                setattr(self, name, {"bytes": b"", "bool": False}.get(kind, 0))

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(
            list(getattr(self, f[1])) == list(getattr(other, f[1]))
            if f[2].startswith("rep_")
            else getattr(self, f[1]) == getattr(other, f[1])
            for f in self._FIELDS
        )

    def __repr__(self):
        body = ", ".join(f"{f[1]}={getattr(self, f[1])!r}" for f in self._FIELDS)
        return f"{type(self).__name__}({body})"

    # -- encoding ---------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for field in self._FIELDS:
            number, name, kind = field[:3]
            value = getattr(self, name)
            if kind in ("uint64", "uint32", "bool"):
                value = int(value)
                limit = {"uint64": _U64, "uint32": _U32, "bool": 1}[kind]
                if not 0 <= value <= limit:
                    raise ValueError(f"{name}={value} out of range for {kind}")
                if value:
                    _put_varint(out, number << 3 | _VARINT)
                    _put_varint(out, value)
            elif kind == "bytes":
                if value:
                    _put_varint(out, number << 3 | _LEN)
                    _put_varint(out, len(value))
                    out += value
            elif kind == "rep_bytes":
                for item in value:
                    _put_varint(out, number << 3 | _LEN)
                    _put_varint(out, len(item))
                    out += item
            elif kind == "rep_message":
                for item in value:
                    blob = item.SerializeToString()
                    _put_varint(out, number << 3 | _LEN)
                    _put_varint(out, len(blob))
                    out += blob
            elif kind == "rep_uint32":
                if value:
                    packed = bytearray()
                    for item in value:
                        item = int(item)
                        if not 0 <= item <= _U32:
                            raise ValueError(f"{name} element {item} out of range")
                        _put_varint(packed, item)
                    _put_varint(out, number << 3 | _LEN)
                    _put_varint(out, len(packed))
                    out += packed
        return bytes(out)

    # -- decoding ---------------------------------------------------------
    def ParseFromString(self, data) -> int:
        self.Clear()
        self.MergeFromString(data)
        return len(data)

    def MergeFromString(self, data) -> int:
        if not isinstance(data, bytes):
            data = bytes(data)
        by_number = {f[0]: f for f in self._FIELDS}
        pos = 0
        while pos < len(data):
            key, pos = _get_varint(data, pos)
            number, wire_type = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            field = by_number.get(number)
            kind = field[2] if field else None
            name = field[1] if field else None
            if kind in ("uint64", "uint32", "bool") and wire_type == _VARINT:
                value, pos = _get_varint(data, pos)
                if kind == "uint32":
                    value &= _U32
                setattr(self, name, bool(value) if kind == "bool" else value)
            elif kind == "bytes" and wire_type == _LEN:
                value, pos = _get_bytes(data, pos)
                setattr(self, name, value)
            elif kind == "rep_bytes" and wire_type == _LEN:
                value, pos = _get_bytes(data, pos)
                getattr(self, name).append(value)
            elif kind == "rep_message" and wire_type == _LEN:
                value, pos = _get_bytes(data, pos)
                getattr(self, name).add().MergeFromString(value)
            elif kind == "rep_uint32" and wire_type == _VARINT:
                value, pos = _get_varint(data, pos)
                getattr(self, name).append(value & _U32)
            elif kind == "rep_uint32" and wire_type == _LEN:
                packed, pos = _get_bytes(data, pos)
                at = 0
                while at < len(packed):
                    value, at = _get_varint(packed, at)
                    getattr(self, name).append(value & _U32)
            else:
                pos = _skip(data, pos, number, wire_type)
        return len(data)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        msg.ParseFromString(data)
        return msg


class Ciphertexts(_Message):
    """A batch of serialized ciphertexts (one query's worth, or one reply)."""

    _FIELDS = ((1, "ct", "rep_bytes"),)


class Request(_Message):
    """Client -> server: query ciphertexts plus the evaluation keys."""

    _FIELDS = (
        (1, "query", "rep_message", Ciphertexts),
        (2, "galois_keys", "bytes"),
        (3, "relin_keys", "bytes"),
    )


class Response(_Message):
    """Server -> client."""

    _FIELDS = ((1, "reply", "rep_message", Ciphertexts),)


class PIRParameters(_Message):
    """The shared setup parameters both parties derive their contexts from."""

    _FIELDS = (
        (1, "num_items", "uint64"),
        (2, "dimensions", "rep_uint32"),
        (3, "encryption_parameters", "bytes"),
        (4, "num_pt", "uint64"),
        (5, "bytes_per_item", "uint32"),
        (6, "items_per_plaintext", "uint32"),
        (7, "bits_per_coeff", "uint32"),
        (8, "use_ciphertext_multiplication", "bool"),
        (9, "reencode_mode", "uint32"),
    )
