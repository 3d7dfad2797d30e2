"""SHA-1 k-hash bloom filter, byte-compatible with the reference
(python/blyss/bloom.py, js/data/bloom.ts). Header: u32-LE k, u32-LE bits."""

from __future__ import annotations

import hashlib
import math


def check_bit(data: bytes, i: int) -> bool:
    return (data[i // 8] & (1 << (7 - (i % 8)))) != 0


def set_bit(data: bytearray, i: int) -> None:
    data[i // 8] |= 1 << (7 - (i % 8))


def top_be_bits(data: bytes, bits: int) -> int:
    num = 0
    for i in range(bits):
        if data[i // 8] & (1 << (7 - (i % 8))):
            num += 1 << (bits - 1 - i)
    return num


def bloom_hash(key: str, hash_idx: int, bits: int) -> int:
    h = hashlib.sha1(hash_idx.to_bytes(4, "little") + key.encode()).digest()
    return top_be_bits(h, bits)


class BloomFilter:
    def __init__(self, k: int, bits: int, data: bytes | bytearray):
        self.k = k
        self.bits = bits
        self.data = data

    @staticmethod
    def from_bytes(raw: bytes) -> "BloomFilter":
        k = int.from_bytes(raw[0:4], "little")
        bits = int.from_bytes(raw[4:8], "little")
        return BloomFilter(k, bits, raw[8:])

    @staticmethod
    def empty(k: int, bits: int) -> "BloomFilter":
        return BloomFilter(k, bits, bytearray((1 << bits) // 8))

    def to_bytes(self) -> bytes:
        return (self.k.to_bytes(4, "little") + self.bits.to_bytes(4, "little")
                + bytes(self.data))

    def insert(self, key: str) -> None:
        for i in range(self.k):
            set_bit(self.data, bloom_hash(key, i, self.bits))

    def lookup(self, key: str) -> bool:
        return all(check_bit(self.data, bloom_hash(key, i, self.bits))
                   for i in range(self.k))

    def indices(self, key: str) -> list[int]:
        return [bloom_hash(key, i, self.bits) for i in range(self.k)]
