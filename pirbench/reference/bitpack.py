# Frozen copy of sdk_tpu_torch/bitpack.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""Bit-packed field I/O matching the reference's read/write_arbitrary_bits
(lib/spiral-rs/src/util.rs:289-321).

The reference's layout — fields packed LSB-first into little-endian u64
words — is exactly the little-endian bitstream of the byte buffer:
bit i of the stream is byte[i//8] >> (i%8) & 1. We exploit that for
vectorized numpy fast paths (np.packbits/unpackbits with bitorder='little').
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64


def read_arbitrary_bits(data: bytes | bytearray, bit_offs: int, num_bits: int) -> int:
    big = int.from_bytes(bytes(data[bit_offs // 8 : bit_offs // 8 + 16]), "little")
    return (big >> (bit_offs % 8)) & ((1 << num_bits) - 1)


def write_arbitrary_bits(data: bytearray, vals, bit_offs: int, num_bits: int) -> None:
    """Write one value or an array of consecutive equal-width fields starting
    at bit_offs. Clears exactly the field bits (read-modify-write), like the
    reference."""
    vals_arr = np.atleast_1d(np.asarray(vals, dtype=U64))
    total_bits = num_bits * len(vals_arr)
    # build the little-endian bitstream for the fields
    shifts = np.arange(num_bits, dtype=U64)
    bits = ((vals_arr[:, None] >> shifts[None, :]) & U64(1)).astype(np.uint8)
    bitstream = bits.reshape(-1)

    start_byte = bit_offs // 8
    start_bit = bit_offs % 8
    end_bit_abs = bit_offs + total_bits
    end_byte = (end_bit_abs + 7) // 8
    span = end_byte - start_byte

    # existing bits in the affected byte span, as a bit array
    existing = np.frombuffer(bytes(data[start_byte:end_byte]), dtype=np.uint8)
    ebits = np.unpackbits(existing, bitorder="little")
    ebits[start_bit : start_bit + total_bits] = bitstream
    packed = np.packbits(ebits, bitorder="little")
    data[start_byte:end_byte] = packed.tobytes()[:span]


def read_fields(data: bytes, bit_offs: int, num_bits: int, count: int) -> np.ndarray:
    """Vectorized read of `count` consecutive `num_bits`-wide fields.
    Requires num_bits <= 56. Returns uint64 array."""
    assert num_bits <= 56
    buf = np.frombuffer(data, dtype=np.uint8)
    offs = bit_offs + num_bits * np.arange(count, dtype=np.int64)
    byte_start = offs // 8
    shift = (offs % 8).astype(U64)
    # gather 8-byte LE windows
    idx = byte_start[:, None] + np.arange(8)[None, :]
    if idx.max() >= len(buf):
        buf = np.concatenate([buf, np.zeros(8, dtype=np.uint8)])
    windows = buf[idx].astype(U64)
    words = np.zeros(count, dtype=U64)
    for b in range(8):
        words |= windows[:, b] << U64(8 * b)
    return (words >> shift) & U64((1 << num_bits) - 1)


def write_fields(data: bytearray, vals: np.ndarray, bit_offs: int, num_bits: int) -> int:
    """Vectorized write of consecutive fields; returns the new bit offset."""
    write_arbitrary_bits(data, vals, bit_offs, num_bits)
    return bit_offs + num_bits * len(np.atleast_1d(vals))


# --- varint (reference lib/spiral-rs/src/key_value.rs:7-23, js/data/varint.ts) ---

def varint_encode(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_decode(data: bytes) -> tuple[int, int]:
    shift = 0
    result = 0
    j = 0
    while shift < 63:
        i = data[j]
        j += 1
        result |= (i & 0x7F) << shift
        shift += 7
        if i & 0x80 == 0:
            break
    return result, j
