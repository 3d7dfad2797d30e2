# Frozen copy of sdk_tpu_torch/poly.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""Host (numpy) polynomial matrices over R_q for the Spiral scheme.

Mirrors the semantics of lib/spiral-rs/src/poly.rs and gadget.rs with
array-first layouts:

- raw (coefficient domain): uint64 array (rows, cols, poly_len), values mod Q
- ntt (evaluation domain):  uint64 array (rows, cols, crt_count, poly_len),
  channel c holding residues mod moduli[c]

These run on the host (client plane + test oracle). The TPU server plane in
sdk_tpu.ops uses 32-bit-safe equivalents.
"""

from __future__ import annotations

import numpy as np

from .arith import U64
from .ntt_host import ntt_forward, ntt_inverse
from .params import Params


def raw_zero(params: Params, rows: int, cols: int) -> np.ndarray:
    return np.zeros((rows, cols, params.poly_len), dtype=U64)


def ntt_zero(params: Params, rows: int, cols: int) -> np.ndarray:
    return np.zeros((rows, cols, params.crt_count, params.poly_len), dtype=U64)


def raw_identity(params: Params, rows: int, cols: int) -> np.ndarray:
    out = raw_zero(params, rows, cols)
    for r in range(rows):
        out[r, r, 0] = 1
    return out


def raw_single_value(params: Params, value: int) -> np.ndarray:
    out = raw_zero(params, 1, 1)
    out[0, 0, 0] = value
    return out


def to_ntt(params: Params, raw: np.ndarray) -> np.ndarray:
    """raw (rows, cols, poly_len) → ntt (rows, cols, crt, poly_len)."""
    chans = []
    for c in range(params.crt_count):
        chans.append(raw % U64(params.moduli[c]))
    stacked = np.stack(chans, axis=-2)
    return ntt_forward(params, stacked)


def to_ntt_no_reduce(params: Params, raw: np.ndarray) -> np.ndarray:
    """As the reference's to_ntt_no_reduce (poly.rs:625-638): copy the raw
    coefficients into every channel without reduction (valid when values are
    already < min(moduli), e.g. gadget-decomposed digits)."""
    stacked = np.stack([raw] * params.crt_count, axis=-2)
    return ntt_forward(params, stacked)


def from_ntt(params: Params, ntt: np.ndarray) -> np.ndarray:
    """ntt (rows, cols, crt, poly_len) → raw (rows, cols, poly_len), CRT-composed."""
    coeffs = ntt_inverse(params, ntt)
    return params.crt_compose_arr(coeffs)


def multiply(params: Params, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NTT-domain matrix product. a: (ra, k, crt, n), b: (k, cb, crt, n).

    Inner-dim bound: products < 2^56, so sums of up to 2^7 terms stay < 2^63.
    """
    assert a.shape[1] == b.shape[0]
    assert a.shape[1] <= 128, "inner dim too large for deferred u64 reduction"
    acc = np.einsum("ikcn,kjcn->ijcn", a, b)
    for c in range(params.crt_count):
        acc[:, :, c, :] %= U64(params.moduli[c])
    return acc


def scalar_multiply(params: Params, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: (1,1,crt,n) NTT scalar; b: (rows,cols,crt,n). Pointwise product."""
    acc = a[0, 0] * b  # < 2^56
    for c in range(params.crt_count):
        acc[:, :, c, :] %= U64(params.moduli[c])
    return acc


def add(params: Params, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    acc = a + b
    for c in range(params.crt_count):
        acc[:, :, c, :] %= U64(params.moduli[c])
    return acc


def invert_raw(params: Params, a: np.ndarray) -> np.ndarray:
    """Negation in raw domain: Q - a (reference invert_poly, poly.rs:387-391;
    note 0 maps to Q, reduced downstream — replicated for bit-exactness)."""
    return U64(params.modulus) - a


def automorph_raw(params: Params, a: np.ndarray, t: int) -> np.ndarray:
    """x -> x^t automorphism on raw polys (poly.rs:393-405)."""
    n = params.poly_len
    i = np.arange(n)
    rem = (i * t) % n
    num = (i * t) // n
    vals = np.where(num % 2 == 0, a[..., i], U64(params.modulus) - a[..., i])
    out = np.zeros_like(a)
    out[..., rem] = vals
    return out


def stack(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([a, b], axis=0)


def pad_top(params: Params, a: np.ndarray, pad_rows: int) -> np.ndarray:
    pad_shape = (pad_rows,) + a.shape[1:]
    return np.concatenate([np.zeros(pad_shape, dtype=U64), a], axis=0)


def shift_rows_by_one(a: np.ndarray) -> np.ndarray:
    """Rotate rows down by one (last row to the top), poly.rs:340-349."""
    if a.shape[0] == 1:
        return a.copy()
    return np.concatenate([a[-1:], a[:-1]], axis=0)


# --- gadget (reference gadget.rs) ---

def get_bits_per(params: Params, dim: int) -> int:
    modulus_log2 = params.modulus_log2
    if dim == modulus_log2:
        return 1
    return int(modulus_log2 / dim) + 1


def build_gadget(params: Params, rows: int, cols: int) -> np.ndarray:
    g = raw_zero(params, rows, cols)
    num_elems = cols // rows
    assert cols % rows == 0
    bits_per = get_bits_per(params, num_elems)
    for i in range(rows):
        for j in range(num_elems):
            if bits_per * j >= 64:
                continue
            g[i, i + j * rows, 0] = 1 << (bits_per * j)
    return g


def gadget_invert_rdim(params: Params, out_rows: int, inp: np.ndarray,
                       rdim: int) -> np.ndarray:
    """G^-1: bit-decompose (rdim, cols, n) raw values into (out_rows, cols, n)
    base-2^bits_per digits (gadget.rs:34-60)."""
    cols = inp.shape[1]
    num_elems = out_rows // rdim
    bits_per = get_bits_per(params, num_elems)
    mask = U64((1 << bits_per) - 1)
    out = np.zeros((out_rows, cols, params.poly_len), dtype=U64)
    for k in range(num_elems):
        bit_offs = min(k * bits_per, 64)
        if bit_offs >= 64:
            piece = np.zeros_like(inp)
        else:
            piece = (inp >> U64(bit_offs)) & mask
        out[k * rdim : (k + 1) * rdim] = piece
    return out


def gadget_invert(params: Params, out_rows: int, inp: np.ndarray) -> np.ndarray:
    return gadget_invert_rdim(params, out_rows, inp, inp.shape[0])


# --- random / noise constructors ---

def random_raw_from_rng(params: Params, rows: int, cols: int, rng) -> np.ndarray:
    """Uniform mod-Q raw matrix drawn as u64 % Q, row-major, matching
    PolyMatrixRaw::random_rng (poly.rs:105-117)."""
    vals = rng.next_u64(rows * cols * params.poly_len)
    vals = vals % U64(params.modulus)
    return vals.reshape(rows, cols, params.poly_len)


def reduce_mod(a: np.ndarray, modulus: int) -> np.ndarray:
    return a % U64(modulus)


def raw_to_bytes(params: Params, a: np.ndarray, modulus_bits: int,
                 num_coeffs: int) -> bytes:
    """PolyMatrixRaw::to_vec (poly.rs:213-235): bit-pack the first num_coeffs
    coefficients of each poly with modulus_bits bits each, rounding the bit
    cursor down to a byte boundary after each poly."""
    from .bitpack import write_arbitrary_bits

    rows, cols = a.shape[0], a.shape[1]
    sz_bits = rows * cols * num_coeffs * modulus_bits
    sz_bytes = (sz_bits + 7) // 8 + 32
    sz_bytes = ((sz_bytes + 15) // 16) * 16
    data = bytearray(sz_bytes)
    bit_offs = 0
    for r in range(rows):
        for c in range(cols):
            write_arbitrary_bits(data, a[r, c, :num_coeffs], bit_offs, modulus_bits)
            bit_offs += num_coeffs * modulus_bits
            bit_offs = (bit_offs // 8) * 8
    return bytes(data)
