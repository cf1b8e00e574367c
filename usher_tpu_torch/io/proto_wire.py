"""Minimal protobuf wire-format codec (no external deps).

Only what the MAT interchange formats need: varint scalars (int32/int64),
length-delimited strings/bytes/sub-messages, and packed repeated int32.
Wire compatibility with protoc-generated C++ code writing proto3 messages.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


def encode_varint(value: int, out: bytearray) -> None:
    value &= _MASK64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def decode_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result & _MASK64, pos
        shift += 7
        if shift >= 64:
            raise ValueError("varint too long")


def to_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def tag(field_number: int, wire_type: int) -> int:
    return (field_number << 3) | wire_type


def write_tag(field_number: int, wire_type: int, out: bytearray) -> None:
    encode_varint(tag(field_number, wire_type), out)


def write_varint_field(field_number: int, value: int, out: bytearray) -> None:
    write_tag(field_number, 0, out)
    encode_varint(value, out)


def write_bytes_field(field_number: int, data: bytes, out: bytearray) -> None:
    write_tag(field_number, 2, out)
    encode_varint(len(data), out)
    out += data


def write_string_field(field_number: int, s: str, out: bytearray) -> None:
    write_bytes_field(field_number, s.encode("utf-8"), out)


def write_packed_int32_field(field_number: int, values, out: bytearray) -> None:
    if not values:
        return
    payload = bytearray()
    for v in values:
        encode_varint(v, payload)
    write_bytes_field(field_number, bytes(payload), out)


def write_packed_float_field(field_number: int, values, out: bytearray) -> None:
    """proto3 packed `repeated float` (4-byte LE IEEE754)."""
    if not values:
        return
    import struct
    write_bytes_field(field_number, struct.pack(f"<{len(values)}f", *values), out)


def decode_packed_float(payload) -> list[float]:
    import struct
    n = len(payload) // 4
    return list(struct.unpack(f"<{n}f", bytes(payload)))


def iter_fields(buf, start: int = 0, end: int | None = None):
    """Yield (field_number, wire_type, value, new_pos).

    For wire type 0, value is the raw varint; for 2, value is a memoryview of
    the payload. Types 1/5 (fixed) are returned as raw ints.
    """
    if end is None:
        end = len(buf)
    mv = memoryview(buf)
    pos = start
    while pos < end:
        key, pos = decode_varint(mv, pos)
        field_number = key >> 3
        wire_type = key & 7
        if wire_type == 0:
            value, pos = decode_varint(mv, pos)
        elif wire_type == 2:
            length, pos = decode_varint(mv, pos)
            value = mv[pos:pos + length]
            pos += length
        elif wire_type == 5:
            value = int.from_bytes(mv[pos:pos + 4], "little")
            pos += 4
        elif wire_type == 1:
            value = int.from_bytes(mv[pos:pos + 8], "little")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_number, wire_type, value


def decode_packed_int32(payload) -> list[int]:
    out = []
    pos = 0
    n = len(payload)
    while pos < n:
        v, pos = decode_varint(payload, pos)
        out.append(to_int32(v))
    return out
