"""Chunk framing for multi-part payloads: u64-LE count, then u64-LE lengths,
then concatenated chunks (reference js/data/serializer.ts,
lib/blyss-rs/src/api.rs:88-115)."""

from __future__ import annotations

import struct

from ..bitpack import varint_decode, varint_encode


def serialize_chunks(chunks: list[bytes]) -> bytes:
    out = bytearray(struct.pack("<Q", len(chunks)))
    for c in chunks:
        out.extend(struct.pack("<Q", len(c)))
    for c in chunks:
        out.extend(c)
    return bytes(out)


def deserialize_chunks(data: bytes) -> list[bytes]:
    (count,) = struct.unpack_from("<Q", data, 0)
    lengths = [struct.unpack_from("<Q", data, 8 + 8 * i)[0] for i in range(count)]
    offs = 8 + 8 * count
    out = []
    for ln in lengths:
        out.append(data[offs : offs + ln])
        offs += ln
    return out


def wrap_key_val(key: bytes, value: bytes) -> bytes:
    """Blyss "kv-item": varint key len, key, varint value len, value
    (python/blyss/serializer.py)."""
    return varint_encode(len(key)) + key + varint_encode(len(value)) + value


def unwrap_key_val(data: bytes) -> tuple[bytes, bytes, int]:
    klen, n = varint_decode(data)
    key = data[n : n + klen]
    offs = n + klen
    vlen, n2 = varint_decode(data[offs:])
    value = data[offs + n2 : offs + n2 + vlen]
    return key, value, offs + n2 + vlen
