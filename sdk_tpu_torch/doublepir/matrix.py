"""u32 matrix transforms for DoublePIR (reference lib/doublepir/src/matrix/*).

Everything is numpy uint32 with wrapping (mod 2^32) semantics — exactly the
reference's arithmetic. Matrices are plain (rows, cols) uint32 ndarrays.
"""

from __future__ import annotations

import math
import os

import numpy as np

U32 = np.uint32
U64 = np.uint64

SQUISH_BASIS = 10
SQUISH_DELTA = 3

DERIVE_CHUNK_SIZE = 65536

# first 16 bytes of SHA256("blyss1") / SHA256("blyss2") — fixed public seeds
# for the shared matrices A1/A2 (reference util/consts.rs:24-33)
SEEDS_SHORT = [
    bytes.fromhex("9c22778545ac229741908e652d333a0f"),
    bytes.fromhex("5fffc482c72a854a10359e9fa2f5e07f"),
]


def derive_aes_bytes(key: bytes, nbytes: int) -> bytes:
    """AES-128-CTR keystream in 64 KiB chunks: chunk i uses IV = BE64(i) || 0^8
    with a 64-bit big-endian block counter (reference derivation.rs:11-22)."""
    return derive_aes_bytes_range(key, 0, nbytes)


def derive_aes_bytes_range(key: bytes, start: int, nbytes: int) -> bytes:
    """Bytes [start, start+nbytes) of the derive_aes_bytes keystream,
    derived independently: each 64 KiB chunk has its own IV, so any range
    is seekable by generating only the chunks it covers (the property the
    reference's streaming derivation relies on, derivation.rs:28-60)."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    c0 = start // DERIVE_CHUNK_SIZE
    c1 = (start + nbytes + DERIVE_CHUNK_SIZE - 1) // DERIVE_CHUNK_SIZE
    out = bytearray()
    zeros = bytes(DERIVE_CHUNK_SIZE)
    for i in range(c0, c1):
        iv = i.to_bytes(8, "big") + bytes(8)
        enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
        out.extend(enc.update(zeros))
    off = start - c0 * DERIVE_CHUNK_SIZE
    return bytes(out[off : off + nbytes])


def derive_from_seed(rows: int, cols: int, key: bytes) -> np.ndarray:
    """Pseudorandom public matrix: AES-CTR keystream read as native-endian u32
    (reference matrix.rs:125-135; native = little-endian on all targets)."""
    raw = derive_aes_bytes(key, rows * cols * 4)
    return np.frombuffer(raw, dtype="<u4").reshape(rows, cols).copy()


def derive_from_seed_rows(row0: int, nrows: int, cols: int,
                          key: bytes) -> np.ndarray:
    """Rows [row0, row0+nrows) of derive_from_seed(R, cols, key) for any
    R >= row0+nrows, without materializing the rest — the streaming-derive
    building block (reference derivation.rs:28-60)."""
    raw = derive_aes_bytes_range(key, row0 * cols * 4, nrows * cols * 4)
    return np.frombuffer(raw, dtype="<u4").reshape(nrows, cols).copy()


# Debug aid (reference matrix.rs:19 `DETERMINISTIC`): SDK_TPU_DETERMINISTIC=1
# replaces every client-side random/gaussian draw with a fixed-seed stream so
# two runs produce identical transcripts when hunting a divergence.
DETERMINISTIC = bool(os.environ.get("SDK_TPU_DETERMINISTIC"))
_DET_RNG = np.random.default_rng(0) if DETERMINISTIC else None


def gaussian(rows: int, cols: int, rng: np.random.Generator) -> np.ndarray:
    """sigma=6.4 discrete gaussian; negatives as two's complement u32
    (reference gaussian.rs, matrix.rs:105-119)."""
    if DETERMINISTIC:
        rng = _DET_RNG
    vals = np.round(rng.standard_normal((rows, cols)) * 6.4).astype(np.int64)
    return vals.astype(U32)


def random_logmod(rows: int, cols: int, logmod: int,
                  rng: np.random.Generator) -> np.ndarray:
    if DETERMINISTIC:
        rng = _DET_RNG
    if logmod == 32:
        return rng.integers(0, 1 << 32, (rows, cols), dtype=U64).astype(U32)
    return rng.integers(0, 1 << logmod, (rows, cols), dtype=U64).astype(U32)


# --- squish: pack delta values of `basis` bits per u32 (squish.rs) ---

def squish(m: np.ndarray, basis: int = SQUISH_BASIS,
           delta: int = SQUISH_DELTA) -> np.ndarray:
    rows, cols = m.shape
    out_cols = (cols + delta - 1) // delta
    pad = out_cols * delta - cols
    mp = np.pad(m, ((0, 0), (0, pad)))
    mp = mp.reshape(rows, out_cols, delta)
    out = np.zeros((rows, out_cols), dtype=U32)
    for k in range(delta):
        out += mp[:, :, k] << U32(k * basis)
    return out


def unsquish(m: np.ndarray, orig_cols: int, basis: int = SQUISH_BASIS,
             delta: int = SQUISH_DELTA) -> np.ndarray:
    rows, cols = m.shape
    mask = U32((1 << basis) - 1)
    out = np.zeros((rows, cols * delta), dtype=U32)
    for k in range(delta):
        out[:, k::delta] = (m >> U32(k * basis)) & mask
    return out[:, :orig_cols]


# --- contract/expand: one large value <-> delta centered base-p digits ---

def centered_to_raw(val: np.ndarray, modulus: int) -> np.ndarray:
    """(val + p/2) truncated to u32, then mod p (reference arith.rs:24-27 —
    the u32 cast before the modulo matters for wrapped negatives)."""
    s = (val.astype(U64) + U64(modulus // 2)) & U64(0xFFFFFFFF)
    return (s % U64(modulus)).astype(U32)


def raw_to_centered(val: np.ndarray, modulus: int) -> np.ndarray:
    return val - U32(modulus // 2)   # wrapping


def expand(m: np.ndarray, modulus: int, delta: int) -> np.ndarray:
    """(rows, cols) -> (rows*delta, cols): base-p digits, centered
    (contract.rs:56-71)."""
    rows, cols = m.shape
    out = np.zeros((rows * delta, cols), dtype=U32)
    val = m.copy()
    for f in range(delta):
        out[f::delta] = raw_to_centered(val % U32(modulus), modulus)
        val //= U32(modulus)
    return out


def contract(m: np.ndarray, modulus: int, delta: int) -> np.ndarray:
    """(rows, cols) -> (rows/delta, cols): recompose base-p from centered
    digits (contract.rs:35-53). Arithmetic wraps mod 2^32."""
    rows, cols = m.shape
    out = np.zeros((rows // delta, cols), dtype=U32)
    coeff = 1
    for f in range(delta):
        digits = centered_to_raw(m[f::delta], modulus)
        out += digits * U32(coeff & 0xFFFFFFFF)   # wrapping
        coeff = (coeff * modulus) & 0xFFFFFFFF
    return out


def transpose_expand_concat_cols_squish(m: np.ndarray, modulus: int,
                                        delta: int, concat: int,
                                        basis: int = SQUISH_BASIS,
                                        d: int = SQUISH_DELTA) -> np.ndarray:
    """Fused transform between answer stages (indexing.rs:117-143):
    out[(i*delta+f) + cols*delta*(j%concat)][(j//concat)//d] +=
        ((m[j,i] base-p digit f) << (basis*((j//concat)%d)))."""
    rows, cols = m.shape
    out_rows = cols * delta * concat
    out_cols = (rows // concat + d - 1) // d
    out = np.zeros((out_rows, out_cols), dtype=U32)
    j = np.arange(rows)
    c = j // concat
    jmod = j % concat
    val = m.astype(U64)
    for i in range(cols):
        v = val[:, i].copy()
        for f in range(delta):
            digit = (v % U64(modulus)).astype(U32)
            r = (i * delta + f) + cols * delta * jmod
            np.add.at(out, (r, c // d), digit << U32(basis) * (c % d).astype(U32))
            v //= U64(modulus)
    return out


def matmul_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact wrapping (mod 2^32) u32 matmul via 16-bit-split float64 BLAS.

    Each 16x16-bit partial product < 2^32; f64 accumulates exactly up to
    2^53, so reduction chunks of <= 2^20 keep every sum exact. The (hi, hi)
    pair contributes a multiple of 2^32 and vanishes mod 2^32.
    """
    K = a.shape[1]
    CHUNK = 1 << 20
    out = np.zeros((a.shape[0], b.shape[1]), dtype=U32)
    for s in range(0, K, CHUNK):
        e = min(s + CHUNK, K)
        a_lo = (a[:, s:e] & U32(0xFFFF)).astype(np.float64)
        a_hi = (a[:, s:e] >> U32(16)).astype(np.float64)
        b_lo = (b[s:e] & U32(0xFFFF)).astype(np.float64)
        b_hi = (b[s:e] >> U32(16)).astype(np.float64)
        m = np.uint64(0xFFFFFFFF)
        ll = (a_lo @ b_lo).astype(np.uint64) & m
        lh = (a_lo @ b_hi).astype(np.uint64) & np.uint64(0xFFFF)
        hl = (a_hi @ b_lo).astype(np.uint64) & np.uint64(0xFFFF)
        out += (ll + ((lh + hl) << np.uint64(16))).astype(U32)
    return out


def mat_mul_vec_packed(a_packed: np.ndarray, b: np.ndarray,
                       basis: int = SQUISH_BASIS,
                       delta: int = SQUISH_DELTA) -> np.ndarray:
    """unsquish(a) @ b, wrapping u32 (reference kernels.rs:14-178).
    b: (cols*delta, K) — K > 1 batches query columns over one DB pass."""
    rows, cols = a_packed.shape
    bv = b.reshape(cols * delta, -1)
    mask = U32((1 << basis) - 1)
    out = np.zeros((rows, bv.shape[1]), dtype=U32)
    for k in range(delta):
        out += matmul_u32((a_packed >> U32(k * basis)) & mask, bv[k::delta])
    return out


def mat_mul_transposed_packed(a_packed: np.ndarray, b: np.ndarray,
                              basis: int = SQUISH_BASIS,
                              delta: int = SQUISH_DELTA) -> np.ndarray:
    """unsquish(a) @ b.T, wrapping u32 (reference kernels.rs:180-278).
    b: (rb, cols*delta)."""
    rows, cols = a_packed.shape
    rb, cb = b.shape
    assert cb == cols * delta
    mask = U32((1 << basis) - 1)
    out = np.zeros((rows, rb), dtype=U32)
    for k in range(delta):
        out += matmul_u32((a_packed >> U32(k * basis)) & mask,
                          np.ascontiguousarray(b[:, k::delta].T))
    return out
