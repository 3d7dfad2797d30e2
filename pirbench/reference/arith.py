# Frozen copy of sdk_tpu_torch/arith.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""Host-side modular arithmetic for the Spiral scheme (numpy uint64 + ints).

Semantics match the reference (lib/spiral-rs/src/arith.rs); implementations
are numpy-vectorized where products fit in u64 and exact Python integers
elsewhere. The TPU-side 32-bit-safe equivalents live in sdk_tpu.ops.limb32.
"""

from __future__ import annotations

import math

import numpy as np

U64 = np.uint64


def log2_exact(a: int) -> int:
    return a.bit_length() - 1


def log2_ceil(a: int) -> int:
    # Matches reference f64-based ceil(log2(a)) (arith.rs:13-15); exact for
    # the magnitudes used (< 2^58).
    return math.ceil(math.log2(a))


def multiply_uint_mod(a: int, b: int, modulus: int) -> int:
    return (a * b) % modulus


def exponentiate_uint_mod(operand: int, exponent: int, modulus: int) -> int:
    return pow(operand, exponent, modulus)


def invert_uint_mod(value: int, modulus: int) -> int | None:
    try:
        return pow(value, -1, modulus)
    except ValueError:
        return None


def reverse_bits(x: int, bit_count: int) -> int:
    if bit_count == 0:
        return 0
    return int(f"{x:0{bit_count}b}"[::-1], 2)


def reverse_bits_arr(x: np.ndarray, bit_count: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(bit_count):
        out |= ((x >> i) & 1) << (bit_count - 1 - i)
    return out


def div2_uint_mod(operand: int, modulus: int) -> int:
    # (operand / 2) mod modulus for odd modulus
    if operand & 1:
        return (operand + modulus) >> 1
    return operand >> 1


def recenter(val: int, from_modulus: int, to_modulus: int) -> int:
    """Reference arith.rs:91-104: recenter a mod-`from` value into mod-`to`."""
    assert from_modulus >= to_modulus
    a_val = int(val)
    if val >= from_modulus // 2:
        a_val -= from_modulus
    a_val = a_val + (from_modulus // to_modulus) * to_modulus + 2 * to_modulus
    return a_val % to_modulus


def recenter_mod(val: int, small_modulus: int, large_modulus: int) -> int:
    """Reference arith.rs:415-427: lift a centered mod-p value into mod-q."""
    assert val < small_modulus
    v = int(val)
    if v > small_modulus // 2:
        v -= small_modulus
    if v < 0:
        v += large_modulus
    return v


def recenter_mod_arr(vals: np.ndarray, small_modulus: int, large_modulus: int) -> np.ndarray:
    """Vectorized recenter_mod over a uint64 array."""
    v = vals.astype(np.int64)
    v = np.where(v > small_modulus // 2, v - small_modulus, v)
    v = np.where(v < 0, v + large_modulus, v)
    return v.astype(U64)


def rescale(a: int, inp_mod: int, out_mod: int) -> int:
    """Reference arith.rs:429-444: modulus switch with rounding."""
    inp_val = int(a) % inp_mod
    if inp_val >= inp_mod // 2:
        inp_val -= inp_mod
    sign = 1 if inp_val >= 0 else -1
    val = inp_val * out_mod
    num = val + sign * (inp_mod // 2)
    # Rust i128 division truncates toward zero; Python // floors.
    result = abs(num) // inp_mod
    if num < 0:
        result = -result
    result = (result + (inp_mod // out_mod) * out_mod + 2 * out_mod) % out_mod
    assert result >= 0
    return (result + out_mod) % out_mod


def rescale_arr(a: np.ndarray, inp_mod: int, out_mod: int) -> np.ndarray:
    """Vectorized rescale for uint64 arrays. Products can exceed 64 bits, so
    split the centered value into 28-bit halves and do the rounded division
    exactly with u64 intermediates.

    round-to-nearest (ties away from zero, matching the reference's
    (val + sign*(inp/2)) // inp with truncation toward -inf for positives...
    The reference uses i128 arithmetic; we replicate exactly using Python-int
    fallback when out_mod is large, else u64 ops.
    """
    if inp_mod.bit_length() + out_mod.bit_length() <= 63:
        v = a.astype(np.int64) % inp_mod
        v = np.where(v >= inp_mod // 2, v - inp_mod, v)
        sign = np.where(v >= 0, 1, -1).astype(np.int64)
        num = v * out_mod + sign * (inp_mod // 2)
        # Rust integer division truncates toward zero.
        res = (np.sign(num) * (np.abs(num) // inp_mod)).astype(np.int64)
        res = (res + (inp_mod // out_mod) * out_mod + 2 * out_mod) % out_mod
        return res.astype(U64)
    # exact fallback
    flat = a.reshape(-1)
    out = np.array([rescale(int(x), inp_mod, out_mod) for x in flat], dtype=U64)
    return out.reshape(a.shape)


def get_barrett_crs(modulus: int) -> tuple[int, int]:
    """floor(2^128 / modulus) as (lo64, hi64) — reference arith.rs:106-111."""
    q = (1 << 128) // modulus
    return q & ((1 << 64) - 1), q >> 64
