"""Key -> PIR row mapping and row-payload parsing.

Row payload format (reference key_value.rs:42-66, write.rs:69-127):
    [ hash_bytes_len:u8 | (key_hash[hash_bytes], varint value_len, value)* ]
Key -> row: top ceil(log2 num_items) bits of SHA-256(key), big-endian
(key_value.rs:25-40).
"""

from __future__ import annotations

import hashlib
import math

from ..bitpack import varint_decode, varint_encode

VARINT_MAX_BYTES = 8
DEFAULT_KEY_HASH_BYTES = 8


def row_from_key(num_items: int, key: str) -> int:
    buckets_log2 = math.ceil(math.log2(num_items))
    h = hashlib.sha256(key.encode()).digest()
    idx = 0
    for i in range(buckets_log2):
        if h[i // 8] & (1 << (7 - (i % 8))):
            idx += 1 << (buckets_log2 - i - 1)
    return idx


def hash_key(key: str, key_hash_bytes: int) -> bytes:
    h = hashlib.sha256(key.encode()).digest()
    return h[len(h) - key_hash_bytes:]


def extract_result(key: str, result: bytes) -> bytes:
    """Find `key`'s value in a decoded row payload; raises KeyError if
    absent (key_value.rs:42-66)."""
    hash_bytes = result[0]
    target = hash_key(key, hash_bytes)
    i = 1
    while i < len(result):
        key_hash = result[i : i + hash_bytes]
        i += hash_bytes
        value_len, n = varint_decode(result[i : i + VARINT_MAX_BYTES])
        i += n
        value = result[i : i + value_len]
        i += value_len
        if key_hash == target:
            return bytes(value)
    raise KeyError(key)
