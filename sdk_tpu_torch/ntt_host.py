"""Host (numpy) negacyclic NTT, bit-identical to the reference
(lib/spiral-rs/src/ntt.rs). Used by the client and as the oracle for the
TPU kernels in sdk_tpu.ops.ntt_tpu.

Harvey butterflies with Shoup-scaled twiddles and lazy reduction in
[0, 4q). Vectorized over arbitrary leading batch dims; the last axis is the
polynomial coefficient axis.
"""

from __future__ import annotations

import numpy as np

from .params import Params

U64 = np.uint64
_MASK32 = U64(0xFFFFFFFF)


def ntt_forward_channel(x: np.ndarray, table: np.ndarray, table_prime: np.ndarray,
                        modulus: int) -> np.ndarray:
    """Forward negacyclic NTT over one CRT channel.

    x: (..., n) uint64 with values < modulus (or anything < 2^32; reduced
    lazily). Returns (..., n) uint64 in [0, modulus).
    """
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    two_q = U64(2 * modulus)
    q = U64(modulus)
    op = x.astype(U64).copy()
    batch = op.shape[:-1]
    for mm in range(log_n):
        m = 1 << mm
        t = n >> (mm + 1)
        v = op.reshape(batch + (m, 2, t))
        xs = v[..., 0, :]
        ys = v[..., 1, :]
        w = table[m : 2 * m].reshape((m, 1))
        wp = table_prime[m : 2 * m].reshape((m, 1))
        curr_x = xs - two_q * (xs >= two_q)
        q_tmp = (ys * wp) >> U64(32)
        q_new = w * ys - q_tmp * q
        v[..., 0, :] = curr_x + q_new
        v[..., 1, :] = curr_x + (two_q - q_new)
    op -= two_q * (op >= two_q)
    op -= q * (op >= q)
    return op


def ntt_inverse_channel(x: np.ndarray, table: np.ndarray, table_prime: np.ndarray,
                        modulus: int) -> np.ndarray:
    """Inverse negacyclic NTT over one CRT channel (includes 1/n scaling via
    the halved twiddle tables, as in the reference)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    two_q = U64(2 * modulus)
    q = U64(modulus)
    one = U64(1)
    op = x.astype(U64).copy()
    batch = op.shape[:-1]
    for mm in reversed(range(log_n)):
        h = 1 << mm
        t = n >> (mm + 1)
        v = op.reshape(batch + (h, 2, t))
        xs = v[..., 0, :]
        ys = v[..., 1, :]
        w = table[h : 2 * h].reshape((h, 1))
        wp = table_prime[h : 2 * h].reshape((h, 1))
        t_tmp = two_q - ys + xs
        curr_x = xs + ys - two_q * ((xs << one) >= t_tmp)
        h_tmp = (t_tmp * wp) >> U64(32)
        v[..., 0, :] = (curr_x + q * (t_tmp & one)) >> one
        v[..., 1, :] = w * t_tmp - h_tmp * q
    op -= two_q * (op >= two_q)
    op -= q * (op >= q)
    return op


def ntt_forward(params: Params, x: np.ndarray) -> np.ndarray:
    """x: (..., crt_count, poly_len) uint64 → same shape, forward NTT per channel."""
    out = np.empty_like(x, dtype=U64)
    for c in range(params.crt_count):
        tbl = params.ntt_tables[c]
        out[..., c, :] = ntt_forward_channel(x[..., c, :], tbl[0], tbl[1], params.moduli[c])
    return out


def ntt_inverse(params: Params, x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x, dtype=U64)
    for c in range(params.crt_count):
        tbl = params.ntt_tables[c]
        out[..., c, :] = ntt_inverse_channel(x[..., c, :], tbl[2], tbl[3], params.moduli[c])
    return out
