"""Row write path: splice-update of row payloads, bzip2 compression, and the
JSON-of-base64 write body (reference lib/server/src/db/write.rs)."""

from __future__ import annotations

import base64
import bz2
import json

from ..bitpack import varint_decode, varint_encode
from .key_value import DEFAULT_KEY_HASH_BYTES, VARINT_MAX_BYTES, hash_key, row_from_key


def update_row(row: bytearray, key: str, value: bytes) -> None:
    """Insert/replace/delete `key` in a row payload in place
    (write.rs:69-127). Empty value deletes the key."""
    if len(row) == 0:
        row.append(DEFAULT_KEY_HASH_BYTES)
    key_hash_bytes = row[0]
    target = hash_key(key, key_hash_bytes)

    i = 1
    found_start = found_end = False
    start = end = 0
    while i < len(row):
        key_hash = bytes(row[i : i + key_hash_bytes])
        i += key_hash_bytes
        if key_hash == target:
            found_start = True
            start = i
        value_len, n = varint_decode(bytes(row[i : i + VARINT_MAX_BYTES]))
        i += n + value_len
        if key_hash == target:
            found_end = True
            end = i

    if found_start:
        assert found_end

    if len(value) == 0:
        assert found_start, "deleting a key that is not present"
        start -= key_hash_bytes
        new_value = b""
    else:
        new_value = varint_encode(len(value)) + value

    if found_start:
        row[start:end] = new_value
    else:
        row.extend(target)
        row.extend(new_value)


def unwrap_kv_pairs(data: bytes) -> list[tuple[str, bytes]]:
    """JSON object {key: base64(value) | null}; null deletes
    (write.rs:129-145 + the python SDK's delete convention)."""
    obj = json.loads(data)
    out = []
    for k, v in obj.items():
        out.append((k, b"" if v is None else base64.b64decode(v)))
    return out


def compress_row(row: bytes) -> bytes:
    """bzip2 at max compression, as the reference (write.rs:176-180)."""
    return bz2.compress(bytes(row), 9)
