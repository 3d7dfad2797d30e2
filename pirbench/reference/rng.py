# Frozen copy of sdk_tpu_torch/rng.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""ChaCha20 keystream RNG, stream-compatible with Rust's `rand_chacha::ChaCha20Rng`.

The Spiral wire formats are "seed-compressed": the pseudorandom first row of
every serialized matrix is regenerated from a 32-byte seed instead of being
transmitted (reference: lib/spiral-rs/src/client.rs:55-127). Byte
compatibility with the reference clients therefore requires an identical
u64 stream for a given seed.

rand_chacha's ChaCha20Rng is the original (djb) ChaCha variant: 64-bit block
counter in state words 12..14, 64-bit stream id (0) in words 14..16. The
RNG surface consumes the keystream as little-endian u32 words; `next_u64`
takes two consecutive words (lo, hi). We only ever draw aligned u64s, which
matches every use on the public (seeded) paths of the reference.

Keystream generation runs through OpenSSL's native ChaCha20 when the
`cryptography` package is present (it is in this image): OpenSSL's EVP
ChaCha20 is the same djb variant — its 16-byte "nonce" parameter is state
words 12..15 verbatim, so packing the 64-bit block counter LE into the
first 8 bytes (stream id 0 in the rest) reproduces rand_chacha's state
exactly, verified byte-identical against the numpy block function across
counter offsets 0, 5, 2^31 and 2^33 (OpenSSL carries the counter into word
13). ~500x faster than the numpy rounds (6 us vs ~3 ms per 16 KiB draw) —
this is the host-side cost of every seed-compressed deserialize, ~4 ms of
the per-query parse path before the swap. The numpy implementation stays
as the readable reference and import-time fallback.
"""

from __future__ import annotations

import struct

import numpy as np

try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    def _chacha20_keystream(seed: bytes, counter0: int, nbytes: int) -> bytes:
        nonce = struct.pack("<Q", counter0) + bytes(8)
        enc = Cipher(algorithms.ChaCha20(seed, nonce), mode=None).encryptor()
        return enc.update(bytes(nbytes))
except ImportError:  # pragma: no cover — cryptography is in the image
    _chacha20_keystream = None

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

_U32 = np.uint32


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << _U32(n)) | (x >> _U32(32 - n))


def _quarter(state: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    # state: (16, nblocks) uint32
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 16)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 12)
    state[a] += state[b]
    state[d] = _rotl(state[d] ^ state[a], 8)
    state[c] += state[d]
    state[b] = _rotl(state[b] ^ state[c], 7)


def chacha20_blocks(key_words: np.ndarray, counter0: int, nblocks: int) -> np.ndarray:
    """Generate `nblocks` consecutive 64-byte blocks starting at block counter
    `counter0`. Returns uint32 array of shape (nblocks, 16) (LE word order)."""
    counters = np.arange(counter0, counter0 + nblocks, dtype=np.uint64)
    init = np.empty((16, nblocks), dtype=np.uint32)
    init[0:4] = _CONSTANTS[:, None]
    init[4:12] = key_words[:, None]
    init[12] = counters.astype(np.uint32)
    init[13] = (counters >> np.uint64(32)).astype(np.uint32)
    init[14] = 0
    init[15] = 0

    x = init.copy()
    old = np.seterr(over="ignore")
    try:
        for _ in range(10):  # 20 rounds = 10 double rounds
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        x += init
    finally:
        np.seterr(**old)
    return x.T.copy()  # (nblocks, 16)


class ChaCha20Rng:
    """Word-stream view over the ChaCha20 keystream for a 32-byte seed."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32, "seed must be 32 bytes"
        self._seed = seed
        self.key_words = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        self._block_counter = 0  # next block index to generate
        self._buf = np.empty((0,), dtype=np.uint32)  # leftover u32 words

    def _refill(self, nwords: int) -> None:
        need_blocks = (nwords - len(self._buf) + 15) // 16
        if _chacha20_keystream is not None:
            raw = _chacha20_keystream(self._seed, self._block_counter,
                                      need_blocks * 64)
            blocks = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
        else:
            blocks = chacha20_blocks(self.key_words, self._block_counter,
                                     need_blocks).reshape(-1)
        self._block_counter += need_blocks
        self._buf = np.concatenate([self._buf, blocks])

    def next_u32_words(self, n: int) -> np.ndarray:
        if len(self._buf) < n:
            self._refill(n)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_u64(self, n: int) -> np.ndarray:
        """Draw n u64 values (each consumes two consecutive u32 words, lo first)."""
        w = self.next_u32_words(2 * n).astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))

    def fill_bytes(self, n: int) -> bytes:
        nwords = (n + 3) // 4
        w = self.next_u32_words(nwords)
        return w.astype("<u4").tobytes()[:n]
