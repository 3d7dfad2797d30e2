"""Spiral server stages on PyTorch tensors.

Ports sdk_tpu/ops/spiral_jax.py. Word-identical to it on the same inputs:

  expansion : automorphism-based coefficient expansion (dense, and the
              compacted sparse schedule) + Regev->GSW; one launch of kernel
              E (csrc/expansion.cu) per round for a whole batch, over a
              work list per round that every query shares
              (dense_schedule, sparse_schedule); expansion_round_plain,
              composed of the plain A', E' (csrc/expand_round.cu), A and B,
              is its plain version. Then one launch of the regev_to_gsw
              kernel (csrc/regev_to_gsw.cu, kernel B redesigned) makes the
              whole batch's folding keys and their negations
              (regev_to_gsw_neg; plain: the A', A, B chain of
              regev_to_gsw_plain and get_v_folding_neg_plain)
  scan      : encrypted-query x DB product over the dense index (kernel C,
              csrc/scan.cu) or the compact index (kernel I,
              csrc/scan_compact.cu)
  fold      : GSW external products over db_dim_2 rounds, one launch of
              kernel F (csrc/fold_round.cu) per round for a whole batch
  pack      : recombine n*n scalar cts into one matrix ct (versions 0, 1),
              and with pack_encode from_ntt and the response encode too,
              kernel G (csrc/pack.cu), one launch for a whole batch

Representation (see modops): NTT matrices are int32 ``(rows, cols, crt, n)``
residues; raw matrices are int64 ``(rows, cols, n)`` values mod Q. The dense
DB is one int8 tensor of 7-bit limbs laid out for the scan kernel's loads:
``(crt, z, L, dim0/4, instances, trials, num_per, 4)`` where the last axis
holds columns 4*jw .. 4*jw+3 (see csrc/scan.cu). The compact DB
(:class:`CompactDb`) has the same layout with a per-bin slot axis of
``cap_bin`` in place of dim0. ``matmul_mod`` is kernel group B
(csrc/matmul_mod.cu; off the read path, which runs its redesign
csrc/regev_to_gsw.cu); the NTTs are kernel group A (ops/ntt.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import poly as hpoly
from ..params import Params

from .. import _build
from .modops import (add_mod, crt_compose, moduli_column, mul_mod, neg_mod_Q,
                     reduce_channels, shoup_companion_arr, u32_bits)
from .ntt import (core_pad, ntt_forward, ntt_forward_plain, ntt_inverse,
                  ntt_inverse_plain)
from .ntt import tables as ntt_tables

LIMB_BITS = 7
NUM_LIMBS = 4  # 4 x 7 = 28 bits covers both CRT moduli (q < 2^28)
_SCAN_CHUNK = 64  # plain scan: 64 products < 2^56 each keep an int64 sum exact


# ---------------------------------------------------------------------------
# domain conversions
# ---------------------------------------------------------------------------

def to_ntt(params: Params, raw: torch.Tensor) -> torch.Tensor:
    """raw int64 (..., n) -> NTT int32 (..., crt, n)."""
    return ntt_forward(params, reduce_channels(params, raw))


def from_ntt(params: Params, x: torch.Tensor) -> torch.Tensor:
    """NTT int32 (..., crt, n) -> raw int64 (..., n), CRT-composed."""
    return crt_compose(params, ntt_inverse(params, x))


# ---------------------------------------------------------------------------
# modular matmul over NTT-domain matrices: kernel group B
# ---------------------------------------------------------------------------

def _matmul_shapes(a: torch.Tensor, b: torch.Tensor):
    batch = b.shape[:-4]
    ab = a.ndim - 4
    if a.shape[:ab] != batch[:ab] or a.shape[-3] != b.shape[-4]:
        raise ValueError(f"matmul_mod shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return batch, ab


def matmul_mod_plain(params: Params, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Exact int64 products summed over k (k * 2^56 < 2^63 for k < 128),
    reduced once per channel."""
    batch, ab = _matmul_shapes(a, b)
    ra, k = a.shape[-4], a.shape[-3]
    a_b = a.reshape(batch[:ab] + (1,) * (len(batch) - ab) + a.shape[-4:])
    acc = None
    for kk in range(k):
        ak = a_b[..., :, kk:kk + 1, :, :].to(torch.int64)   # (.., ra, 1, crt, n)
        bk = b[..., kk:kk + 1, :, :, :].to(torch.int64)     # (.., 1, cb, crt, n)
        t = ak * bk
        acc = t if acc is None else acc + t
    q = moduli_column(params, b.device)
    return (acc % q).to(torch.int32)


def _matmul_launch(params: Params, a: torch.Tensor, a_shoup, b: torch.Tensor):
    batch, ab = _matmul_shapes(a, b)
    ra, k, cb = a.shape[-4], a.shape[-3], b.shape[-3]
    if a.dtype != torch.int32 or b.dtype != torch.int32 or k > 256:
        raise ValueError("matmul_mod kernel takes int32 operands and k <= 256")
    a = a.contiguous()
    b = b.contiguous()
    tensors = [a, b] + ([a_shoup.contiguous()] if a_shoup is not None else [])
    _build.require_cuda(*tensors)
    nb = int(np.prod(batch, dtype=np.int64))
    na = int(np.prod(a.shape[:ab], dtype=np.int64))
    out = torch.empty(batch + (ra, cb, params.crt_count, params.poly_len),
                      dtype=torch.int32, device=b.device)
    q0, q1 = params.moduli
    _build.launch("matmul_mod", "sdk_matmul_mod", b.device, a.data_ptr(),
                  tensors[2].data_ptr() if a_shoup is not None else None,
                  b.data_ptr(), out.data_ptr(), nb, nb // max(na, 1), ra, k,
                  cb, params.poly_len, q0, q1, _build.stream_of(b))
    return out


def matmul_mod(params: Params, a, b: torch.Tensor) -> torch.Tensor:
    """NTT-domain modular matmul.

    a: int32 (*abatch, ra, k, crt, n), or a (w, w_shoup) pair of such tensors
    for session key material with precomputed Shoup companions; abatch
    aligns with the first dims of b's batch.
    b: int32 (..., k, cb, crt, n). Returns int32 (..., ra, cb, crt, n) in
    [0, q_c)."""
    a_shoup = None
    if isinstance(a, tuple):
        a, a_shoup = a
    if b.device.type == "cuda":
        return _matmul_launch(params, a, a_shoup, b)
    if b.device.type == "cpu":
        return matmul_mod_plain(params, a, b)
    raise ValueError(f"unsupported device {b.device}")


def scalar_mulmod(params: Params, s: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """s: (crt, n) NTT scalar poly; b: (..., crt, n). Pointwise product."""
    return mul_mod(params, s, b)


# ---------------------------------------------------------------------------
# raw-domain ops
# ---------------------------------------------------------------------------

def automorph_tables(params: Params, t: int):
    """Gather permutation + negation mask for x -> x^t (reference
    poly.rs:393-405 scatter, inverted into a gather)."""
    n = params.poly_len
    i = np.arange(n)
    perm = np.zeros(n, dtype=np.int64)
    neg = np.zeros(n, dtype=bool)
    perm[(i * t) % n] = i
    neg[(i * t) % n] = ((i * t) // n) % 2 == 1
    return perm, neg


def automorph_pair(params: Params, raw: torch.Tensor, perm: torch.Tensor,
                   neg: torch.Tensor) -> torch.Tensor:
    """Apply the automorphism to raw values; negation is Q - x (0 -> Q)."""
    g = raw.index_select(-1, perm)
    return torch.where(neg, neg_mod_Q(params, g), g)


def _get_bits_per(params: Params, dim: int) -> int:
    if dim == params.modulus_log2:
        return 1
    return int(params.modulus_log2 / dim) + 1


def gadget_digits(params: Params, raw: torch.Tensor, out_rows: int,
                  rdim: int) -> torch.Tensor:
    """G^-1: decompose raw (..., rdim, cols, n) into (..., out_rows, cols, n)
    base-2^bits_per digits (reference gadget.rs:34-60); out[k*rdim + r] is
    digit k of row r. Digits at bit offsets >= 64 are zero."""
    num_elems = out_rows // rdim
    bits_per = _get_bits_per(params, num_elems)
    mask = (1 << min(bits_per, 32)) - 1
    pieces = []
    for k in range(num_elems):
        off = k * bits_per
        if off >= 64:       # a shift by >= 64 is undefined in torch
            pieces.append(torch.zeros_like(raw))
        else:
            pieces.append((raw >> off) & mask)
    stacked = torch.stack(pieces, dim=-4)   # (..., num_elems, rdim, cols, n)
    return stacked.reshape(stacked.shape[:-4] + (out_rows,)
                           + stacked.shape[-2:])


def invert_raw_pair(params: Params, raw: torch.Tensor) -> torch.Tensor:
    """Q - x (0 -> Q, as reference invert_poly)."""
    return neg_mod_Q(params, raw)


# ---------------------------------------------------------------------------
# first-dimension scan: kernel group C
# ---------------------------------------------------------------------------

def db_shape(params: Params) -> tuple:
    """Shape of the dense int8 DB tensor (see the module docstring)."""
    dim0 = 1 << params.db_dim_1
    return (params.crt_count, params.poly_len, NUM_LIMBS, dim0 // 4,
            params.instances, params.n * params.n, 1 << params.db_dim_2, 4)


def db_limbs(params: Params, vals: torch.Tensor) -> torch.Tensor:
    """Residues (crt, z, inst, trials, num_per, dim0) (< 2^28, any integer
    dtype) -> the dense int8 DB tensor (see db_shape)."""
    crt, z, inst, trials, npr, dim0 = vals.shape
    v = vals.to(torch.int32).reshape(crt, z, inst, trials, npr, dim0 // 4, 4)
    limbs = torch.stack([((v >> (LIMB_BITS * k)) & 127).to(torch.int8)
                         for k in range(NUM_LIMBS)], dim=2)
    # (crt, z, L, inst, trials, npr, jw, 4) -> (crt, z, L, jw, inst, trials,
    # npr, 4)
    return limbs.permute(0, 1, 2, 6, 3, 4, 5, 7).contiguous()


def db_write_items(params: Params, db: torch.Tensor, bins, cols,
                   vals: torch.Tensor) -> None:
    """Write item residues into a dense or compact planes tensor in place:
    vals (K, instances * trials, crt, z) int32 NTT residues of K items, item
    k at num_per bin bins[k] and column cols[k] (its dim0 index in the dense
    DB, its slot in the compact one); the (bin, column) pairs are
    distinct."""
    num_per = 1 << params.db_dim_2
    view = db.view(db.shape[:4] + (-1, num_per, 4))  # (.., jw, it, npr, 4)
    limbs = torch.stack([((vals >> (LIMB_BITS * k)) & 127).to(torch.int8)
                         for k in range(NUM_LIMBS)], dim=-1)
    ii = torch.as_tensor(bins, dtype=torch.int64).to(db.device)
    jj = torch.as_tensor(cols, dtype=torch.int64).to(db.device)
    # the advanced indices (dims 3, 5, 6) are separated by a slice, so the
    # indexed shape is (K, crt, z, L, it)
    view[:, :, :, jj // 4, :, ii, jj % 4] = limbs.permute(0, 2, 3, 4, 1)


def db_values(db: torch.Tensor) -> torch.Tensor:
    """Inverse of db_limbs: int32 (crt, z, inst, trials, num_per, dim0), the
    residues (< 2^28) assembled from their limbs in place."""
    crt, z, L, jw, inst, trials, npr, four = db.shape
    v = db[:, :, 0].to(torch.int32)
    for k in range(1, L):
        v |= db[:, :, k].to(torch.int32) << (LIMB_BITS * k)
    return v.permute(0, 1, 3, 4, 5, 2, 6).reshape(
        crt, z, inst, trials, npr, jw * four)


def firstdim_multiply_plain(params: Params, db: torch.Tensor,
                            q_arr: torch.Tensor) -> torch.Tensor:
    """Exact int64 dot products in chunks of 64 columns, reduced per chunk."""
    vals = db_values(db)
    crt, z, inst, trials, npr, dim0 = vals.shape
    vals = vals.reshape(crt, z, inst * trials * npr, dim0)
    qv = q_arr.to(torch.int64)                        # (crt, z, dim0, R)
    q = moduli_column(params, db.device, 3)
    acc = None
    for j0 in range(0, dim0, _SCAN_CHUNK):
        j1 = min(dim0, j0 + _SCAN_CHUNK)
        part = (vals[..., j0:j1, None] * qv[:, :, None, j0:j1, :]).sum(-2) % q
        acc = part if acc is None else (acc + part) % q
    return acc.to(torch.int32).reshape(crt, z, inst, trials, npr, -1)


class ScanTiling(NamedTuple):
    """How kernel C cuts its work (see csrc/scan.cu): a block takes cgb
    column groups of ntw 8-column tiles (ncb blocks across the R columns)
    and wm x mtw m16 tiles (bx blocks across the M rows), with the query
    limbs of kc k32 steps (a multiple of the two of an iteration) in shared
    memory."""

    ntw: int
    ncb: int
    cgb: int
    wm: int
    mtw: int
    bx: int
    kc: int


_SCAN_SMEM = 128 * 1024    # query fragments of a block: 1 KB a (step, tile)
_SCAN_BLOCKS = 1056        # eight blocks an SM of the H100's 132


def scan_tiling(R: int, M: int, Z: int, JW: int, ntw: int | None = None,
                warps: int | None = None,
                mtw: int | None = None) -> ScanTiling:
    """Kernel C's tiling for R columns, M rows, Z z-slices of two channels
    and JW words of dim0 (defaults from the sweep of
    tools/scan_bench_gpu.py on the H100, PERF.md). ntw (tiles of a warp):
    the widest of 4, 2, 1 that divides the R / 8 tiles; a block has at most
    ``warps`` warps (4 at ntw 4, whose 252 registers a thread leave room
    for two such blocks an SM, else 8); a warp of one tile takes one m16
    tile (many short blocks: no wave of blocks is left half full), wider
    warps take as many m16 tiles as keep enough blocks to fill the card."""
    nt = -(-R // 8)
    if ntw is None:
        ntw = next(w for w in (4, 2, 1) if nt % w == 0)
    if warps is None:
        warps = 4 if ntw == 4 else 8
    if ntw not in (1, 2, 4) or not 1 <= warps <= 8:
        raise ValueError(f"scan tiling: ntw {ntw}, warps {warps}")
    groups = -(-nt // ntw)
    cgb = min(groups, warps)
    ncb = -(-groups // cgb)
    wm = max(1, warps // cgb)
    nks = -(-JW // 8)
    kc = min(-(-nks // 2), _SCAN_SMEM // (2048 * cgb * ntw)) * 2
    mt = -(-M // 16)
    if mtw is None and ntw == 1:
        mtw = 1
    if mtw is None:
        bx = max(1, min(-(-mt // wm), -(-_SCAN_BLOCKS // (2 * Z * ncb))))
        mtw = -(-mt // (wm * bx))
    mtw = min(mtw, -(-mt // wm))
    bx = -(-mt // (wm * mtw))
    return ScanTiling(ntw, ncb, cgb, wm, mtw, bx, kc)


def _scan_launch(params: Params, db: torch.Tensor, q_arr: torch.Tensor,
                 tiling: ScanTiling | None = None):
    crt, z, L, jw, inst, trials, npr, _ = db.shape
    R = q_arr.shape[-1]
    M = inst * trials * npr
    if (db.dtype != torch.int8 or q_arr.dtype != torch.int32
            or q_arr.shape != (crt, z, 4 * jw, R) or crt != 2 or R % 2
            or 4 * jw > 1 << 15       # int32 weight sums: 4*127^2*dim0 < 2^31
            or 4 * jw * M >= 1 << 31):
        raise ValueError(f"scan: db {db.dtype} {tuple(db.shape)}, query "
                         f"{q_arr.dtype} {tuple(q_arr.shape)}")
    q_arr = q_arr.contiguous()
    _build.require_cuda(db, q_arr)
    tl = tiling or scan_tiling(R, M, z, jw)
    out = torch.empty((crt, z, inst, trials, npr, R), dtype=torch.int32,
                      device=db.device)
    q0, q1 = params.moduli
    _build.launch("scan", "sdk_scan", db.device, db.data_ptr(),
                  q_arr.data_ptr(), out.data_ptr(), z, M, jw, R, *tl, q0, q1,
                  _build.stream_of(db))
    return out


def firstdim_multiply(params: Params, db, q_arr: torch.Tensor) -> torch.Tensor:
    """Encrypted-query x DB product (reference compute/dot_product.rs).

    db: the dense int8 DB tensor (db_shape), or a :class:`CompactDb`.
    q_arr: int32 (crt, z, dim0, R) residues (R = 2 rows x batched queries,
    column 2*i + r). Returns int32 (crt, z, inst, trials, num_per, R),
    exact mod q_c; the compact index gives the dense result of its
    equivalent dense index."""
    compact = isinstance(db, CompactDb)
    device = (db.planes if compact else db).device
    if device.type == "cuda":
        return (_scan_compact_launch if compact else _scan_launch)(
            params, db, q_arr)
    if device.type == "cpu":
        return (firstdim_multiply_compact_plain if compact
                else firstdim_multiply_plain)(params, db, q_arr)
    raise ValueError(f"unsupported device {device}")


# ---------------------------------------------------------------------------
# compact index: kernel I (reference lib/server/src/db/sparse_db.rs:1-48)
# ---------------------------------------------------------------------------

class CompactDb(NamedTuple):
    """O(populated) DB: per num_per bin, up to cap_bin populated first-dim
    columns (ports spiral_jax.CompactDb, one layout).

    planes: int8 (crt, z, L, cap_bin/4, instances, trials, num_per, 4), the
            dense layout with the slot axis in place of dim0, so that the
            compact scan streams each row's slots with the dense scan's
            coalesced 4-byte loads and one word is one __dp4a operand;
            zero limbs where a slot is unoccupied (they add exactly zero).
    idx_j:  int32 (num_per, cap_bin), each slot's dim0 coordinate (0 where
            unoccupied). cap_bin is a multiple of 4.
    """

    planes: torch.Tensor
    idx_j: torch.Tensor

    @property
    def cap_bin(self) -> int:
        return self.idx_j.shape[1]


def compact_shape(params: Params, cap_bin: int) -> tuple:
    """Shape of the compact planes (db_shape with cap_bin columns)."""
    if cap_bin % 4:
        raise ValueError(f"cap_bin {cap_bin} is not a multiple of 4")
    return (params.crt_count, params.poly_len, NUM_LIMBS, cap_bin // 4,
            params.instances, params.n * params.n, 1 << params.db_dim_2, 4)


def compact_db_empty(params: Params, device, cap_bin: int = 8) -> CompactDb:
    """Empty compact DB: O(num_per * cap_bin) device bytes instead of the
    dense O(num_per * dim0)."""
    return CompactDb(
        torch.zeros(compact_shape(params, cap_bin), dtype=torch.int8,
                    device=device),
        torch.zeros((1 << params.db_dim_2, cap_bin), dtype=torch.int32,
                    device=device))


def firstdim_multiply_compact_plain(params: Params, db: CompactDb,
                                    q_arr: torch.Tensor) -> torch.Tensor:
    """Exact int64 sums over each bin's slots of DB value x the gathered
    query column, in chunks of 64 slots, reduced per chunk."""
    vals = db_values(db.planes)          # (crt, z, inst, trials, npr, cap)
    crt, z, inst, trials, npr, cap = vals.shape
    vals = vals.reshape(crt, z, inst * trials, npr, cap)
    idx = db.idx_j.to(torch.int64)
    qv = q_arr.to(torch.int64)           # (crt, z, dim0, R)
    q = moduli_column(params, qv.device, 4)
    acc = None
    for s0 in range(0, cap, _SCAN_CHUNK):
        s1 = min(cap, s0 + _SCAN_CHUNK)
        qg = qv[:, :, idx[:, s0:s1]]     # (crt, z, npr, cs, R)
        part = (vals[..., s0:s1, None] * qg[:, :, None]).sum(-2) % q
        acc = part if acc is None else (acc + part) % q
    return acc.to(torch.int32).reshape(crt, z, inst, trials, npr, -1)


class CompactScanTiling(NamedTuple):
    """How kernel I cuts its work (see csrc/scan_compact.cu): a block packs
    the query limbs of rb columns (ncb blocks across the R columns; a warp
    runs ntw 8-column tiles over them) and takes gpb groups of 64 / sw bins
    (nbb blocks across the num_per bins), with ns stages of sw slot words
    (ns - 1 steps' copies in flight), copied 16 bytes at a time (vec 1) or
    4."""

    ntw: int
    rb: int
    ncb: int
    gpb: int
    nbb: int
    ns: int
    vec: int
    sw: int


_COMPACT_SMEM = 232448     # dynamic shared memory a block can have (H100)


def compact_scan_smem(rb: int, dim0: int, ns: int, sw: int = 8) -> int:
    """Shared bytes of a kernel-I block: ns stages of DB words (16 KB) and
    the idx_j of 64 / sw bins, the epilogue constants and the packed query
    limbs of dim0 rows x rb columns (rows padded by a word at rb >= 8)."""
    ld = rb + 1 if rb >= 8 else rb
    return 4 * (ns * (4096 + 32 * (64 // sw)) + 16 + dim0 * ld)


@functools.lru_cache(maxsize=None)
def compact_scan_tiling(R: int, npr: int, dim0: int, cap: int,
                        ntw: int | None = None, gpb: int | None = None,
                        rb: int | None = None, ns: int | None = None,
                        vec: int | None = None,
                        sw: int | None = None) -> CompactScanTiling:
    """Kernel I's tiling for R columns, npr bins, dim0 query rows and cap
    slots a bin (defaults from the sweep of tools/scan_bench_gpu.py --kernel
    compact on the H100, PERF.md). ntw (tiles of a warp): 4 above 16
    columns, 2 above 8, else 1; a block takes rb = min(R, 8 ntw) columns
    and the most of 4 stages that fit, half the columns (and ntw with them)
    while even two stages do not fit; a stage holds sw = 8 slot words of 8
    bins, or at cap 16 / 8 the 4 / 2 words there are of 16 / 32 bins; 16-byte
    copies where a row's bins are 16-byte aligned (npr % 4 == 0). A block
    takes all the bins of its (channel, z), so that it packs the query once,
    but for one 8-column tile over more than one k32 step: then two groups,
    so that the blocks that share a 128-byte line of the index run side by
    side (one block walks a line's four groups 4 steps apart, and the L2
    loses the line between)."""
    if sw is None:
        sw = 2 if cap <= 8 else 4 if cap <= 16 else 8

    def fits(rb_, ns_):
        return compact_scan_smem(rb_, dim0, ns_, sw) <= _COMPACT_SMEM

    if ntw is None and rb is None:
        rb = min(R, 32 if R > 16 else 16 if R > 8 else 8)
        while rb > 2 and not fits(rb, ns or 2):
            rb = max(2, rb // 2 & ~1)
        ntw = 1 if rb <= 8 else 2 if rb <= 16 else 4
    if rb is None:
        rb = min(R, 8 * max(ntw, 1))
    if ns is None:
        ns = next((n for n in (4, 3, 2) if fits(rb, n)), 2)
    if vec is None:
        vec = int(npr % 4 == 0)
    if (ntw not in (1, 2, 4) or rb < 2 or rb % 2 or rb > 8 * ntw or R % 2
            or ns not in (2, 3, 4) or not fits(rb, ns)
            or vec not in (0, 1) or (vec and npr % 4)
            or not (sw == 8 or (sw in (2, 4) and cap <= 4 * sw))):
        raise ValueError(f"scan_compact tiling: ntw {ntw}, rb {rb}, ns {ns}, "
                         f"vec {vec}, sw {sw}, R {R}, npr {npr}, dim0 {dim0}, "
                         f"cap {cap}")
    nbg = -(-npr // (64 // sw))
    if gpb is None:
        gpb = 2 if ntw == 1 and cap > 32 else nbg
    gpb = max(1, min(gpb, nbg))
    return CompactScanTiling(ntw, rb, -(-R // rb), gpb, -(-nbg // gpb), ns,
                             vec, sw)


def _scan_compact_launch(params: Params, db: CompactDb, q_arr: torch.Tensor,
                         tiling: CompactScanTiling | None = None):
    planes, idx_j = db
    crt, z, L, cw, inst, trials, npr, _ = planes.shape
    dim0, R = q_arr.shape[-2:]
    if (planes.dtype != torch.int8 or idx_j.dtype != torch.int32
            or tuple(idx_j.shape) != (npr, 4 * cw) or q_arr.dtype != torch.int32
            or q_arr.shape[:2] != (crt, z) or crt != 2 or R % 2
            or 4 * cw > 1 << 15):     # int32 weight sums: 4*127^2*cap < 2^31
        raise ValueError(f"scan_compact: planes {planes.dtype} "
                         f"{tuple(planes.shape)}, idx_j {idx_j.dtype} "
                         f"{tuple(idx_j.shape)}, query {q_arr.dtype} "
                         f"{tuple(q_arr.shape)}")
    q_arr = q_arr.contiguous()
    _build.require_cuda(planes, idx_j, q_arr)
    tl = tiling or compact_scan_tiling(R, npr, dim0, 4 * cw)
    if planes.data_ptr() % 16:            # rows not 16-byte aligned
        tl = tl._replace(vec=0)
    if idx_j.data_ptr() % 16:
        idx_j = idx_j.clone()
    M = inst * trials * npr
    out = torch.empty((crt, z, inst, trials, npr, R), dtype=torch.int32,
                      device=planes.device)
    q0, q1 = params.moduli
    _build.launch("scan_compact", "sdk_scan_compact", planes.device,
                  planes.data_ptr(), idx_j.data_ptr(), q_arr.data_ptr(),
                  out.data_ptr(), z, M, npr, cw, dim0, R, *tl, q0, q1,
                  ctypes.addressof(_epilogue_array(q0, q1)),
                  _build.stream_of(planes))
    return out


@functools.lru_cache(maxsize=None)
def _epilogue_array(q0: int, q1: int):
    """Both channels' epilogue constants as the uint32 [2][10] the kernel
    takes (kept alive by the cache)."""
    return (ctypes.c_uint32 * 20)(*epilogue_constants(q0),
                                  *epilogue_constants(q1))


def epilogue_constants(q: int) -> list[int]:
    """Kernel I's epilogue constants for modulus q: w_s = 2^{7s} mod q for
    s < 7, then c = 2^32 mod q and Shoup's floor(2^32 c / q) and
    floor(2^32 / q)."""
    c = (1 << 32) % q
    return [pow(2, 7 * s, q) for s in range(7)] + [c, (c << 32) // q,
                                                   (1 << 32) // q]


# ---------------------------------------------------------------------------
# coefficient expansion (reference server.rs:19-121)
# ---------------------------------------------------------------------------

_NTT_PERMS: dict = {}


def ntt_automorph_perms(params: Params) -> np.ndarray:
    """(rounds, crt, n) int32: the permutation P_r of NTT slots with
    NTT(a(x^t))[k] = NTT(a)[P_r[k]] mod q_c for t = n / 2^r + 1.

    A negacyclic NTT evaluates a at the roots psi_k = NTT(x)[k] of x^n + 1,
    and a(x^t) at psi_k is a at psi_k^t, itself such a root (t odd): the
    automorphism of a ring element is a gather of its NTT slots. Q - v is
    -v mod q_c, so the reference's negation (0 -> Q) is the same map. Cached
    per (n, moduli)."""
    n, moduli = params.poly_len, tuple(params.moduli)
    if (n, moduli) in _NTT_PERMS:
        return _NTT_PERMS[(n, moduli)]
    mono = np.zeros((1, 1, n), dtype=np.uint64)
    mono[0, 0, 1] = 1
    psi = hpoly.to_ntt(params, mono)[0, 0]            # (crt, n)
    out = np.empty((params.poly_len_log2, len(moduli), n), dtype=np.int32)
    for c, q in enumerate(moduli):
        vals = [int(v) for v in psi[c]]
        slot = {v: k for k, v in enumerate(vals)}
        for r in range(params.poly_len_log2):
            t = (n >> r) + 1
            out[r, c] = [slot[pow(v, t, q)] for v in vals]
    _NTT_PERMS[(n, moduli)] = out
    return out


class ExpansionPlan:
    """Static data for one Params on one device, a row a round: the NTT'd
    -x^(2048-2^r) scalars (neg1) and their Shoup companions, the
    automorphism tables (``perm_all`` int32 gather permutations,
    ``negm_all`` bool negation masks, one byte a word as kernels E and E'
    read them) and the NTT-slot permutation of each automorphism
    (ntt_automorph_perms)."""

    def __init__(self, params: Params, device):
        self.params = params
        neg1 = np.stack([hpoly.to_ntt(params, p.reshape(1, 1, -1))[0, 0]
                         for p in params.get_v_neg1_raw()])   # (L, crt, n)
        perms, negs = zip(*(automorph_tables(params, (params.poly_len >> r) + 1)
                            for r in range(params.poly_len_log2)))
        self.neg1 = u32_bits(neg1, device)
        self.neg1_shoup = u32_bits(shoup_companion_arr(params, neg1), device)
        self.perm_all = torch.from_numpy(np.stack(perms).astype(np.int32)
                                         ).to(device)
        self.negm_all = torch.from_numpy(np.stack(negs).astype(bool)).to(device)
        self.perm_ntt = torch.from_numpy(ntt_automorph_perms(params)).to(device)

    def auto(self, r: int) -> tuple:
        """Round r's automorphism tables (perm, neg), as expand_round takes
        them."""
        return self.perm_all[r], self.negm_all[r]


def expand_round_plain(params: Params, x: torch.Tensor, t_tables,
                       t_exp: int) -> torch.Tensor:
    """x: int32 (B, 2, 1, crt, n) inverse-NTT residues of B cts. Returns the
    int32 (B*t_exp + B, crt, n) input of the round's forward NTT: the row-0
    gadget digits of the automorphed cts, copied into every channel
    unreduced ((b, k) polys, b major), then row 1 reduced per channel."""
    perm, neg = t_tables
    raw = automorph_pair(params, crt_compose(params, x), perm, neg)
    crt, n = params.crt_count, params.poly_len
    digits = gadget_digits(params, raw[:, 0:1], t_exp, 1).to(torch.int32)
    digits = digits.unsqueeze(-2).expand(digits.shape[:-1] + (crt, n))
    row1 = reduce_channels(params, raw[:, 1:2])
    return torch.cat([digits.reshape(-1, crt, n), row1.reshape(-1, crt, n)])


def _expand_round_launch(params: Params, x: torch.Tensor, t_tables,
                         t_exp: int) -> torch.Tensor:
    perm, neg = t_tables
    B = x.shape[0]
    crt, n = params.crt_count, params.poly_len
    if (x.dtype != torch.int32 or tuple(x.shape) != (B, 2, 1, crt, n)
            or crt != 2 or perm.dtype != torch.int32 or neg.dtype != torch.bool
            or perm.shape != (n,) or neg.shape != (n,)):
        raise ValueError(f"expand_round: x {x.dtype} {tuple(x.shape)}, perm "
                         f"{perm.dtype} {tuple(perm.shape)}, neg {neg.dtype}")
    x = x.contiguous()
    _build.require_cuda(x, perm, neg)
    out = torch.empty((B * t_exp + B, crt, n), dtype=torch.int32,
                      device=x.device)
    q0, q1 = params.moduli
    _build.launch("expand_round", "sdk_expand_round", x.device, x.data_ptr(),
                  perm.data_ptr(), neg.data_ptr(), out.data_ptr(), B,
                  params.poly_len_log2, t_exp, _get_bits_per(params, t_exp),
                  params.modulus, q0, q1, params.inv_q0_mod_q1,
                  _build.stream_of(x))
    return out


def expand_round(params: Params, x: torch.Tensor, t_tables,
                 t_exp: int) -> torch.Tensor:
    """Kernel E' (csrc/expand_round.cu) on a CUDA tensor, its plain version
    (expand_round_plain, same contract) on a CPU tensor."""
    if x.device.type == "cuda":
        return _expand_round_launch(params, x, t_tables, t_exp)
    if x.device.type == "cpu":
        return expand_round_plain(params, x, t_tables, t_exp)
    raise ValueError(f"unsupported device {x.device}")


class SparseExpansionPlan:
    """Compacted expansion schedule for a populated first-dim set (ports
    spiral_jax.SparseExpansionPlan; reference per-round skip sets,
    query_expansion.rs:213-248).

    Round r processes only the ancestors of needed leaves: the Regev leaves
    {stride*i : i populated} (stride 2 with further dims, else 1) and the
    first max_bits_to_gen_right odd (GSW) leaves. Each round gathers its
    live entries from the previous round's (parent_pos), negates those in
    the upper half (neg_mask), updates the even group with the left key and
    the odd group with the right key (left iff r > 0 and the entry is even,
    query_expansion.rs:85-99), and gathers the round's result (src_sel) from
    [even updates, odd updates, carried bases].

    The JAX plan pads every index array to a power of two so that jit
    retraces less, and pads the leaf scatter with out-of-bounds indices that
    jnp drops. PyTorch runs eagerly: here every array has its exact size and
    nothing is padded (index_put raises on an out-of-bounds index), which
    leaves every output word unchanged."""

    def __init__(self, params: Params, populated_dim0,
                 max_bits_to_gen_right: int, device="cpu"):
        g = params.g()
        stop_round = params.stop_round() if params.db_dim_2 > 0 else 0
        dim0 = 1 << params.db_dim_1
        pop = sorted({int(i) for i in populated_dim0})
        if not pop or pop[0] < 0 or pop[-1] >= dim0:
            raise ValueError(f"populated dim0 set must be a non-empty subset "
                             f"of [0, {dim0})")
        self.params = params
        self.populated = pop

        # needed[r]: entries (indices in [0, 2^(r+1))) whose value after
        # round r feeds a used leaf
        stride = 2 if params.db_dim_2 > 0 else 1
        needed = [set() for _ in range(g)]
        needed[g - 1].update(stride * i for i in pop)
        if params.db_dim_2 > 0:
            needed[g - 1].update(2 * i + 1 for i in range(max_bits_to_gen_right))
        for r in range(g - 2, -1, -1):
            sz = 1 << (r + 1)
            needed[r] = {e for e in range(sz)
                         if e in needed[r + 1] or e + sz in needed[r + 1]}

        def update_ok(r: int, e: int) -> bool:
            if stop_round > 0 and r > stop_round and e % 2 == 1:
                return False
            if (stop_round > 0 and r == stop_round and e % 2 == 1
                    and e // 2 >= max_bits_to_gen_right):
                return False
            return True

        def idx(values) -> torch.Tensor:
            return torch.tensor(list(values), dtype=torch.int64, device=device)

        self.rounds = []
        live_prev = [0]
        for r in range(g):
            live = sorted(needed[r])
            pos_prev = {e: k for k, e in enumerate(live_prev)}
            ev = [k for k, e in enumerate(live)
                  if update_ok(r, e) and r > 0 and e % 2 == 0]
            od = [k for k, e in enumerate(live)
                  if update_ok(r, e) and not (r > 0 and e % 2 == 0)]
            src_sel = list(range(len(ev) + len(od), len(ev) + len(od)
                                 + len(live)))   # default: the carried base
            for j, k in enumerate(ev):
                src_sel[k] = j
            for j, k in enumerate(od):
                src_sel[k] = len(ev) + j
            self.rounds.append(dict(
                parent_pos=idx(pos_prev[e % (1 << r)] for e in live),
                neg_mask=torch.tensor([e >= (1 << r) for e in live],
                                      device=device),
                even_sel=idx(ev), odd_sel=idx(od), src_sel=idx(src_sel)))
            live_prev = live

        leaf_pos = {e: k for k, e in enumerate(live_prev)}
        self.even_leaf_pos = idx(leaf_pos[stride * i] for i in pop)
        self.even_dim0_idx = idx(pop)
        # int32: the regev_to_gsw kernel reads the GSW leaves by position
        self.odd_leaf_pos = idx(leaf_pos[2 * i + 1]
                                for i in range(max_bits_to_gen_right)
                                if params.db_dim_2 > 0).to(torch.int32)
        self.schedule = sparse_schedule(self, device)


# ---------------------------------------------------------------------------
# the batched expansion: one round for every query of a batch, kernel E
# (csrc/expansion.cu)
# ---------------------------------------------------------------------------

LEFT, RIGHT, CARRIED = 0, 1, 2      # an entry's key side in a round


class ExpansionRound(NamedTuple):
    """One round of an expansion schedule, shared by every query of a
    batch: ``items`` int32 (n_items, 4) rows (output position, parent
    position in the previous round, negate flag, side: LEFT, RIGHT or
    CARRIED), one per output entry, the updated entries first; n_in and
    n_out entries before and after the round; n_left / n_right entries
    updated with each key."""

    items: torch.Tensor
    n_in: int
    n_out: int
    n_left: int
    n_right: int

    @property
    def n_update(self) -> int:
        return self.n_left + self.n_right


def _round_items(out_parent_neg_side: list, n_in: int, device) -> ExpansionRound:
    rows = sorted(out_parent_neg_side, key=lambda t: (t[3] == CARRIED, t[0]))
    arr = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    sides = arr[:, 3]
    return ExpansionRound(torch.from_numpy(arr).to(device), n_in, len(rows),
                          int((sides == LEFT).sum()),
                          int((sides == RIGHT).sum()))


def dense_schedule(params: Params, max_bits_to_gen_right: int,
                   device="cpu") -> list[ExpansionRound]:
    """The rounds of the dense expansion (spiral_jax.coefficient_expansion)
    as work lists: entry i of round r (2^(r+1) entries) has parent i mod
    2^r, negated when i >= 2^r; the right key at r = 0 and for odd i, the
    left key for even i; carried where the stop-round masks say so
    (reference server.rs:33-44)."""
    stop_round = params.stop_round() if params.db_dim_2 > 0 else 0
    rounds = []
    for r in range(params.g()):
        half = 1 << r
        rows = []
        for i in range(2 * half):
            side = RIGHT if r == 0 or i % 2 else LEFT
            if stop_round > 0 and i % 2 and (
                    r > stop_round or (r == stop_round
                                       and i // 2 >= max_bits_to_gen_right)):
                side = CARRIED
            rows.append((i, i % half, int(i >= half), side))
        rounds.append(_round_items(rows, half, device))
    return rounds


def sparse_schedule(splan: SparseExpansionPlan,
                    device="cpu") -> list[ExpansionRound]:
    """The rounds of the compacted expansion (SparseExpansionPlan) as work
    lists: entry k of round r has parent parent_pos[k], negated where
    neg_mask[k]; its side from src_sel (into [even updates, odd updates,
    carried bases])."""
    rounds, n_in = [], 1
    for rd in splan.rounds:
        parent = rd["parent_pos"].tolist()
        neg = rd["neg_mask"].tolist()
        n_ev = rd["even_sel"].numel()
        n_upd = n_ev + rd["odd_sel"].numel()
        rows = [(k, parent[k], int(neg[k]),
                 LEFT if s < n_ev else RIGHT if s < n_upd else CARRIED)
                for k, s in enumerate(rd["src_sel"].tolist())]
        rounds.append(_round_items(rows, n_in, device))
        n_in = len(rows)
    return rounds


class ExpansionKeys:
    """Every query's expansion keys for a batch: per query the pp dict's
    lists of keyed (w, w') (2, t_exp, crt, n) matrices, left and right, and
    its keyed conversion key (2, 2 t_conv, crt, n) where it has one.
    Kernels E and the regev_to_gsw kernel read them through a device table
    of pointers, (rounds + 1, NQ, side, w | w'), made once a batch from a
    row of pointers cached in each query's key dict: row r < rounds holds
    round r's expansion keys, row ``rounds`` side 0 the conversion key."""

    def __init__(self, params: Params, pp_devs: list):
        self.params = params
        self.left = [pp["v_exp_left"] for pp in pp_devs]
        self.right = [pp["v_exp_right"] for pp in pp_devs]
        self.conversion = [pp.get("v_conversion") for pp in pp_devs]
        self._pp_devs = pp_devs
        self._table = None

    def __len__(self) -> int:
        return len(self.left)

    def round_keys(self, r: int, side: int) -> list:
        """Each query's key of round r on one side (plain versions)."""
        keys = self.left if side == LEFT else self.right
        if any(r >= len(k) for k in keys):
            raise ValueError(f"no {('left', 'right')[side]} expansion key for "
                             f"round {r}")
        return [k[r] for k in keys]

    @staticmethod
    def _pointer_row(params: Params, pp: dict) -> np.ndarray:
        """(rounds + 1, 2, 2) int64 pointers of one query's keys (0 where a
        side has no key), checked once: keyed int32 (2, t_exp, 2, n) and (2,
        2 t_conv, 2, n), contiguous, 16-byte aligned."""
        row = pp.get("_expansion_key_ptrs")
        if row is not None:
            return row
        g = params.g()
        row = np.zeros((g + 1, 2, 2), dtype=np.int64)
        named = [(r, side, f"{name}[{r}]", key, t)
                 for side, (name, t) in enumerate(
                     (("v_exp_left", params.t_exp_left),
                      ("v_exp_right", params.t_exp_right)))
                 for r, key in enumerate(pp[name][:g])]
        if pp.get("v_conversion") is not None:
            named.append((g, 0, "v_conversion", pp["v_conversion"],
                          2 * params.t_conv))
        for r, side, name, key, width in named:
            if not isinstance(key, tuple):
                raise ValueError(f"{name}: the kernels take keyed (w, w') "
                                 f"keys")
            for h, k in enumerate(key):
                if (k.dtype != torch.int32 or not k.is_contiguous()
                        or k.data_ptr() % 16 or tuple(k.shape) != (
                            2, width, params.crt_count, params.poly_len)):
                    raise ValueError(f"key {name}: {k.dtype} "
                                     f"{tuple(k.shape)}")
                row[r, side, h] = k.data_ptr()
        pp["_expansion_key_ptrs"] = row
        return row

    def table(self, device) -> torch.Tensor:
        """int64 (rounds + 1, NQ, 2, 2) pointer table on ``device``."""
        if self._table is None:
            rows = np.stack([self._pointer_row(self.params, pp)
                             for pp in self._pp_devs], axis=1)
            self._table = torch.from_numpy(rows).to(device)
        return self._table


def _update_plain(params: Params, plan: ExpansionPlan, r: int,
                  base: torch.Tensor, keys: list) -> torch.Tensor:
    """The expansion butterfly (spiral_jax._expansion_round_update) on base
    (NQ, B, 2, 1, crt, n), query i with its keyed key keys[i], from the
    plain versions of A', E', A and B only."""
    nq, B = base.shape[:2]
    w = torch.stack([w for w, _ in keys])
    t_exp = w.shape[2]
    x = ntt_inverse_plain(params, base.reshape((nq * B,) + base.shape[2:]))
    fwd = ntt_forward_plain(params, expand_round_plain(params, x, plan.auto(r),
                                                       t_exp))
    ginv = fwd[:nq * B * t_exp].reshape(nq, B, t_exp, 1, *fwd.shape[1:])
    auto1 = fwd[nq * B * t_exp:].reshape(nq, B, 1, 1, *fwd.shape[1:])
    res = add_mod(params, base, matmul_mod_plain(params, w, ginv))
    return torch.cat([res[:, :, 0:1], add_mod(params, res[:, :, 1:2], auto1)],
                     dim=2)


def expansion_round_plain(params: Params, plan: ExpansionPlan, r: int,
                          cts: torch.Tensor, rnd: ExpansionRound,
                          keys: ExpansionKeys) -> torch.Tensor:
    """One expansion round for every query of a batch, in plain PyTorch (the
    plain versions of A', E', A and B, never a kernel). cts: int32 (NQ,
    n_in, 2, 1, crt, n) NTT cts of the previous round; returns (NQ, n_out,
    2, 1, crt, n): entry k = its parent, times plan.neg1[r] where flagged,
    then updated with the query's left or right key of round r, or
    carried."""
    items = rnd.items.to(device=cts.device, dtype=torch.int64)
    base = cts.index_select(1, items[:, 1])
    neg = items[:, 2].bool().reshape(1, -1, 1, 1, 1, 1)
    base = torch.where(neg, mul_mod(params, plan.neg1[r], base), base)
    res = base.clone()
    for side in (LEFT, RIGHT):
        sel = torch.nonzero(items[:, 3] == side).flatten()
        if sel.numel():
            res[:, sel] = _update_plain(params, plan, r,
                                        base.index_select(1, sel),
                                        keys.round_keys(r, side))
    out = torch.empty((cts.shape[0], rnd.n_out) + cts.shape[2:],
                      dtype=cts.dtype, device=cts.device)
    out[:, items[:, 0]] = res
    return out


class ExpansionTiling(NamedTuple):
    """How kernel E cuts a round (see csrc/expansion.cu): an updated
    entry's key digits split over a thread block cluster of ``cluster``
    256-thread blocks (two 128-thread transform groups, one a CRT
    channel)."""

    cluster: int


@functools.lru_cache(maxsize=None)
def expansion_tiling(updates: int, t_exp: int,
                     cluster: int | None = None) -> ExpansionTiling:
    """Kernel E's tiling for a round of ``updates`` updated entries over the
    batch whose narrower key has t_exp digits: one block an entry from 256
    entries up (a wave of the card at two blocks an SM), else a cluster of
    2 blocks from 64 up and of 4 below, as F splits its slots
    (fold_tiling), never more blocks than digits."""
    if cluster is None:
        cluster = 1 if updates >= 256 else 2 if updates >= 64 else 4
        while cluster > t_exp:
            cluster //= 2
    if cluster not in (1, 2, 4):
        raise ValueError(f"expansion tiling: cluster {cluster}")
    return ExpansionTiling(cluster)


def expansion_digit_split(t_exp: int, cluster: int) -> list[range]:
    """The key digits k of an updated entry that each block of a cluster
    takes (csrc/expansion.cu d0, d1)."""
    return [range(rank * t_exp // cluster, (rank + 1) * t_exp // cluster)
            for rank in range(cluster)]


def _expansion_launch(params: Params, plan: ExpansionPlan, r: int,
                      cts: torch.Tensor, rnd: ExpansionRound,
                      keys: ExpansionKeys,
                      tiling: ExpansionTiling | None = None) -> torch.Tensor:
    """Kernel E (csrc/expansion.cu) on one round of every query of the
    batch. ``tiling`` overrides :func:`expansion_tiling` (sweeps, tests)."""
    n = params.poly_len
    nq = cts.shape[0]
    if (cts.dtype != torch.int32 or tuple(cts.shape[1:]) != (
            rnd.n_in, 2, 1, 2, n) or params.crt_count != 2
            or params.poly_len_log2 != 11 or len(keys) != nq
            or not 1 <= params.t_exp_left <= 64
            or not 1 <= params.t_exp_right <= 64):
        raise ValueError(f"expansion: cts {cts.dtype} {tuple(cts.shape)} for "
                         f"a round of {rnd.n_in} -> {rnd.n_out} entries, "
                         f"{len(keys)} key sets")
    if rnd.n_right and any(r >= len(k) for k in keys.right):
        raise ValueError(f"no right expansion key for round {r}")
    cts = cts.contiguous()
    if cts.data_ptr() % 16:                # 16-byte loads of the parents
        cts = cts.clone()
    table = keys.table(cts.device)
    tb = ntt_tables(params, cts.device)
    _build.require_cuda(cts, rnd.items, table, tb, plan.neg1)
    out = torch.empty((nq, rnd.n_out, 2, 1, 2, n), dtype=torch.int32,
                      device=cts.device)
    t_min = min(params.t_exp_left if rnd.n_left else 64,
                params.t_exp_right if rnd.n_right else 64)
    tl = tiling or expansion_tiling(nq * rnd.n_update, t_min)
    q0, q1 = params.moduli
    _build.launch("expansion", "sdk_expansion", cts.device, cts.data_ptr(),
                  out.data_ptr(), rnd.items.data_ptr(), rnd.n_out, rnd.n_in,
                  nq, table.data_ptr() + 8 * table[0].numel() * r,
                  plan.neg1[r].data_ptr(), plan.neg1_shoup[r].data_ptr(),
                  plan.perm_all[r].data_ptr(), plan.negm_all[r].data_ptr(),
                  plan.perm_ntt[r].data_ptr(), tb.data_ptr(),
                  params.t_exp_left, _get_bits_per(params, params.t_exp_left),
                  params.t_exp_right, _get_bits_per(params, params.t_exp_right),
                  params.modulus, q0, q1, params.inv_q0_mod_q1, tl.cluster,
                  _build.stream_of(cts))
    return out


def expansion_round(params: Params, plan: ExpansionPlan, r: int,
                    cts: torch.Tensor, rnd: ExpansionRound,
                    keys: ExpansionKeys) -> torch.Tensor:
    """Kernel E on a CUDA tensor, expansion_round_plain (same contract) on a
    CPU tensor."""
    if cts.device.type == "cuda":
        return _expansion_launch(params, plan, r, cts, rnd, keys)
    if cts.device.type == "cpu":
        return expansion_round_plain(params, plan, r, cts, rnd, keys)
    raise ValueError(f"unsupported device {cts.device}")


def expand_batch(params: Params, plan: ExpansionPlan,
                 schedule: list[ExpansionRound], ct0: torch.Tensor,
                 keys: ExpansionKeys) -> torch.Tensor:
    """ct0: (NQ, 2, 1, crt, n) NTT query cts. Runs every round of the
    schedule for the whole batch, one expansion_round a round; returns the
    last round's entries (NQ, n_out, 2, 1, crt, n)."""
    cts = ct0[:, None]
    for r, rnd in enumerate(schedule):
        cts = expansion_round(params, plan, r, cts, rnd, keys)
    return cts


def _gsw_layout(params: Params, conv: torch.Tensor,
                v_inp: torch.Tensor) -> torch.Tensor:
    """Key products and inputs (..., num_gsw * t_gsw, 2, 1, crt, n) -> the
    folding keys (..., num_gsw, 2, 2 t_gsw, crt, n): column 2j the product
    of leaf j of a GSW ct, column 2j+1 the leaf itself."""
    both = torch.stack([conv, v_inp], dim=-5).reshape(
        v_inp.shape[:-5] + (params.db_dim_2, params.t_gsw * 2, 2,
                            params.crt_count, params.poly_len))
    return both.transpose(-4, -3).contiguous()


def regev_to_gsw_plain(params: Params, v_inp: torch.Tensor,
                       w_conv: torch.Tensor) -> torch.Tensor:
    """Regev -> GSW (spiral_jax.regev_to_gsw) from the plain versions of A',
    A and B only: v_inp (..., num_gsw * t_gsw, 2, 1, crt, n) NTT Regev
    cts, w_conv the (..., 2, 2*t_conv, crt, n) key words (not their Shoup
    companions), its leading dims those of v_inp. Returns (..., num_gsw,
    2, 2*t_gsw, crt, n)."""
    raw = _from_ntt_plain(params, v_inp)
    ginv = gadget_digits(params, raw, 2 * params.t_conv, 2)
    conv = matmul_mod_plain(params, w_conv, _to_ntt_plain(params, ginv))
    return _gsw_layout(params, conv, v_inp)


# ---------------------------------------------------------------------------
# Regev -> GSW of a batch's GSW leaves with the negated folding keys: kernel
# B redesigned (csrc/regev_to_gsw.cu)
# ---------------------------------------------------------------------------

def get_v_folding_neg(params: Params, v_folding: torch.Tensor,
                      gadget_ntt: torch.Tensor) -> torch.Tensor:
    """v_folding: (db_dim_2, 2, 2*t_gsw, crt, n); gadget_ntt: the NTT of
    the gadget matrix, (2, 2*t_gsw, crt, n). The reference's chain through
    from_ntt, Q - x and to_ntt (kernels A' and A on a card)."""
    inv = to_ntt(params, invert_raw_pair(params, from_ntt(params, v_folding)))
    return add_mod(params, gadget_ntt[None], inv)


def get_v_folding_neg_plain(params: Params, v_folding: torch.Tensor,
                            gadget_ntt: torch.Tensor) -> torch.Tensor:
    """get_v_folding_neg from the plain transforms only. (The
    regev_to_gsw kernel stores the same words pointwise: Q = q0 q1, so (Q
    - x) mod q_c = -x mod q_c, and the NTT is linear, so this is (gadget -
    v) mod q_c for canonical v.)"""
    inv = _to_ntt_plain(params, invert_raw_pair(
        params, _from_ntt_plain(params, v_folding)))
    return add_mod(params, gadget_ntt[None], inv)


def negate_folding_keys(params: Params, v_folding: torch.Tensor,
                        gadget_ntt: torch.Tensor) -> torch.Tensor:
    """(gadget - v) mod q_c word by word: get_v_folding_neg's words for
    canonical folding keys v (..., db_dim_2, 2, 2*t_gsw, crt, n), as the
    regev_to_gsw kernel's epilogue stores them. A few elementwise torch ops
    on any device (the direct-upload read's negation)."""
    q = moduli_column(params, v_folding.device).to(torch.int32)
    d = gadget_ntt - v_folding
    return torch.where(d < 0, d + q, d)


def regev_to_gsw_tiling(units: int, sms: int) -> int:
    """The regev_to_gsw kernel's cluster for ``units`` (query, GSW leaf)
    pairs on a card of ``sms`` SMs (csrc/regev_to_gsw.cu): a pair takes a
    cluster of 2 256-thread blocks, block `rank` row `rank`'s digits, while
    the pairs are no more than the SMs (a single read; the blocks then fit
    one wave at two an SM), else one block."""
    return 2 if units <= sms else 1


def regev_to_gsw_neg_plain(params: Params, leaves: torch.Tensor,
                           pos: torch.Tensor, keys: ExpansionKeys,
                           gadget_ntt: torch.Tensor):
    """The plain version of the regev_to_gsw kernel: the GSW leaves
    gathered, regev_to_gsw_plain with each query's key and
    get_v_folding_neg_plain (the transforms, not the pointwise negation)."""
    if any(k is None for k in keys.conversion):
        raise ValueError("regev_to_gsw needs every query's conversion key")
    v_gsw = leaves.index_select(1, pos.to(device=leaves.device,
                                          dtype=torch.int64))
    w = torch.stack([k[0] if isinstance(k, tuple) else k
                     for k in keys.conversion])
    v_folding = regev_to_gsw_plain(params, v_gsw, w)
    return v_folding, get_v_folding_neg_plain(params, v_folding, gadget_ntt)


def _regev_to_gsw_launch(params: Params, leaves: torch.Tensor,
                         pos: torch.Tensor, keys: ExpansionKeys,
                         gadget_ntt: torch.Tensor):
    """The regev_to_gsw kernel (csrc/regev_to_gsw.cu) on every query of a
    batch."""
    n = params.poly_len
    nq = leaves.shape[0]
    n_gsw = params.t_gsw * params.db_dim_2
    if (leaves.dtype != torch.int32 or leaves.ndim != 6
            or tuple(leaves.shape[2:]) != (2, 1, 2, n)
            or pos.dtype != torch.int32 or tuple(pos.shape) != (n_gsw,)
            or gadget_ntt.dtype != torch.int32 or tuple(gadget_ntt.shape)
            != (2, 2 * params.t_gsw, 2, n) or params.crt_count != 2
            or params.poly_len_log2 != 11 or len(keys) != nq or n_gsw == 0):
        raise ValueError(f"regev_to_gsw: leaves {leaves.dtype} "
                         f"{tuple(leaves.shape)}, positions {pos.dtype} "
                         f"{tuple(pos.shape)} for {n_gsw} GSW leaves, gadget "
                         f"{tuple(gadget_ntt.shape)}, {len(keys)} key sets")
    if any(not isinstance(k, tuple) for k in keys.conversion):
        raise ValueError("regev_to_gsw takes every query's keyed (w, w') "
                         "conversion key")
    leaves = leaves.contiguous()
    if leaves.data_ptr() % 16:               # 16-byte loads of the leaves
        leaves = leaves.clone()
    table = keys.table(leaves.device)
    tb = ntt_tables(params, leaves.device)
    _build.require_cuda(leaves, pos, gadget_ntt, table, tb)
    shape = (nq, params.db_dim_2, 2, 2 * params.t_gsw, 2, n)
    fold = torch.empty(shape, dtype=torch.int32, device=leaves.device)
    neg = torch.empty(shape, dtype=torch.int32, device=leaves.device)
    cluster = regev_to_gsw_tiling(nq * n_gsw, _sm_count(leaves.device))
    q0, q1 = params.moduli
    _build.launch("regev_to_gsw", "sdk_regev_to_gsw", leaves.device,
                  leaves.data_ptr(), pos.data_ptr(), leaves.shape[1], nq,
                  fold.data_ptr(), neg.data_ptr(), gadget_ntt.data_ptr(),
                  table.data_ptr() + 8 * table[0].numel() * params.g(),
                  tb.data_ptr(), n_gsw, params.t_gsw, params.t_conv,
                  _get_bits_per(params, params.t_conv), q0, q1,
                  params.inv_q0_mod_q1, cluster, _build.stream_of(leaves))
    return fold, neg


def regev_to_gsw_neg(params: Params, leaves: torch.Tensor, pos: torch.Tensor,
                     keys: ExpansionKeys, gadget_ntt: torch.Tensor):
    """Every query's folding keys and their negations from the batch's
    expansion leaves: leaves int32 (NQ, n_leaves, 2, 1, crt, n) canonical
    NTT cts, pos int32 (t_gsw * db_dim_2,) the GSW leaves' positions among
    them, keys the batch's ExpansionKeys (each query's keyed conversion
    key), gadget_ntt (2, 2 t_gsw, crt, n). Returns (v_folding, v_neg), each
    (NQ, db_dim_2, 2, 2 t_gsw, crt, n): one launch of the regev_to_gsw
    kernel on a CUDA tensor, regev_to_gsw_neg_plain on a CPU tensor."""
    if leaves.device.type == "cuda":
        return _regev_to_gsw_launch(params, leaves, pos, keys, gadget_ntt)
    if leaves.device.type == "cpu":
        return regev_to_gsw_neg_plain(params, leaves, pos, keys, gadget_ntt)
    raise ValueError(f"unsupported device {leaves.device}")


# ---------------------------------------------------------------------------
# fold + pack (reference server.rs:388-468, compute/{fold,pack}.rs)
# ---------------------------------------------------------------------------

def _to_ntt_plain(params: Params, raw: torch.Tensor) -> torch.Tensor:
    return ntt_forward_plain(params, reduce_channels(params, raw))


def _from_ntt_plain(params: Params, x: torch.Tensor) -> torch.Tensor:
    return crt_compose(params, ntt_inverse_plain(params, x))


def _fold_key_dims(params: Params, cts: torch.Tensor, v_folding: torch.Tensor,
                   v_folding_neg: torch.Tensor) -> int:
    """Number of leading per-query dims of the folding keys (vb of
    spiral_jax.fold_ciphertexts); they align with cts' first dims."""
    vb = v_folding.ndim - 5
    tail = (params.db_dim_2, 2, 2 * params.t_gsw, params.crt_count,
            params.poly_len)
    if (vb < 0 or v_folding.shape != v_folding_neg.shape
            or tuple(v_folding.shape[vb:]) != tail
            or v_folding.shape[:vb] != cts.shape[:vb] or vb > cts.ndim - 4):
        raise ValueError(f"fold: cts {tuple(cts.shape)}, keys "
                         f"{tuple(v_folding.shape)} / "
                         f"{tuple(v_folding_neg.shape)}")
    return vb


def fold_round_plain(params: Params, cts: torch.Tensor, v_neg: torch.Tensor,
                     v_fold: torch.Tensor) -> torch.Tensor:
    """One fold round in plain PyTorch (the plain versions of A, B and A',
    never a kernel). cts: raw (..., 2*num_per, 2, 1, n); v_neg, v_fold: the
    round's key matrices (*vb, 2, 2*t_gsw, crt, n). Returns (..., num_per, 2,
    1, n): V_neg (x) a + V_fold (x) b, but b verbatim where a is all zero and
    a verbatim where b is."""
    ell = 2 * params.t_gsw
    num_per = cts.shape[-4] // 2
    a = cts[..., :num_per, :, :, :]
    b = cts[..., num_per:, :, :, :]
    za = (a == 0).flatten(-3).all(-1)[..., None, None, None]
    zb = (b == 0).flatten(-3).all(-1)[..., None, None, None]
    # [V_neg | V_fold] @ [G(a); G(b)] as one matmul with doubled k; the
    # digits go into the NTT unreduced, the same in every channel
    digits = torch.cat([gadget_digits(params, a, ell, 2),
                        gadget_digits(params, b, ell, 2)], dim=-3)
    stacked = digits.to(torch.int32).unsqueeze(-2).expand(
        digits.shape[:-1] + (params.crt_count, params.poly_len))
    g_ntt = ntt_forward_plain(params, stacked)
    v_cat = torch.cat([v_neg, v_fold], dim=-3)
    f = _from_ntt_plain(params, matmul_mod_plain(params, v_cat, g_ntt))
    return torch.where(za, b, torch.where(zb, a, f))


class FoldTiling(NamedTuple):
    """How kernel F cuts a round (see csrc/fold_round.cu): a slot's digit
    polynomials split over a thread block cluster of ``cluster`` 256-thread
    blocks (two 128-thread transform groups, one a CRT channel)."""

    cluster: int


@functools.lru_cache(maxsize=None)
def fold_tiling(slots: int, t_gsw: int,
                cluster: int | None = None) -> FoldTiling:
    """Kernel F's tiling for a round of ``slots`` output slots (defaults
    from the sweep of tools/scan_bench_gpu.py --kernel fold on the H100,
    PERF.md): one block a slot from 128 slots up, else a cluster of 2
    blocks a slot from 32 slots up and of 4 below."""
    if cluster is None:
        cluster = 1 if slots >= 128 else 2 if slots >= 32 else 4
    if cluster not in (1, 2, 4) or cluster > 4 * t_gsw:
        raise ValueError(f"fold tiling: cluster {cluster}, t_gsw {t_gsw}")
    return FoldTiling(cluster)


def fold_digit_split(t_gsw: int, cluster: int) -> list[range]:
    """The digit polynomials d = (which, r, k) -> which * 2 t_gsw + r * t_gsw
    + k of a slot that each block of a cluster takes (csrc/fold_round.cu
    d0, d1)."""
    n = 4 * t_gsw
    return [range(rank * n // cluster, (rank + 1) * n // cluster)
            for rank in range(cluster)]


def _fold_round_launch(params: Params, cts: torch.Tensor, v_folding_neg,
                       v_folding, key: int, vb: int,
                       tiling: FoldTiling | None = None) -> torch.Tensor:
    """Kernel F (csrc/fold_round.cu) on one round; the keys are the whole
    (*vb, db_dim_2, 2, ell, crt, n) tensors, the round's matrix is picked by
    offset. ``tiling`` overrides :func:`fold_tiling` (sweeps)."""
    n = params.poly_len
    num_per = cts.shape[-4] // 2
    if (cts.dtype != torch.int64 or cts.shape[-3:] != (2, 1, n)
            or cts.shape[-4] != 2 * num_per or params.crt_count != 2
            or params.poly_len_log2 != 11
            or v_folding.dtype != torch.int32
            or v_folding_neg.dtype != torch.int32):
        raise ValueError(f"fold_round: cts {cts.dtype} {tuple(cts.shape)}, "
                         f"keys {v_folding.dtype} {tuple(v_folding.shape)}")
    cts = cts.contiguous()
    v_folding = v_folding.contiguous()
    v_folding_neg = v_folding_neg.contiguous()
    # 16-byte loads of int64 pairs and of key words
    cts, v_folding, v_folding_neg = (t.clone() if t.data_ptr() % 16 else t
                                     for t in (cts, v_folding, v_folding_neg))
    tb = ntt_tables(params, cts.device)
    _build.require_cuda(cts, v_folding, v_folding_neg, tb)
    lead = cts.shape[:-4]
    entries = int(np.prod(lead, dtype=np.int64))
    nq = int(np.prod(lead[:vb], dtype=np.int64))
    out = torch.empty(lead + (num_per, 2, 1, n), dtype=torch.int64,
                      device=cts.device)
    ell = 2 * params.t_gsw
    mat = 2 * ell * 2 * n                   # words of one round's key matrix
    q0, q1 = params.moduli
    tl = tiling or fold_tiling(entries * num_per, params.t_gsw)
    _build.launch("fold_round", "sdk_fold_round", cts.device, cts.data_ptr(),
                  out.data_ptr(), v_folding_neg.data_ptr() + 4 * key * mat,
                  v_folding.data_ptr() + 4 * key * mat, tb.data_ptr(),
                  entries, num_per, entries // max(nq, 1),
                  params.db_dim_2 * mat if vb else 0, params.t_gsw,
                  _get_bits_per(params, params.t_gsw), params.poly_len_log2,
                  q0, q1, params.inv_q0_mod_q1, tl.cluster,
                  _build.stream_of(cts))
    return out


def fold_ciphertexts(params: Params, cts: torch.Tensor, v_folding: torch.Tensor,
                     v_folding_neg: torch.Tensor) -> torch.Tensor:
    """cts: raw (..., num_per, 2, 1, n); GSW-driven binary fold, returns
    (..., 2, 1, n). The keys (db_dim_2, 2, 2*t_gsw, crt, n) may carry
    leading per-query dims that align with cts' first dims (the batched
    engine folds every query of a batch in one launch per round).

    Implements the reference's all-zero shortcut (lib/server fold.rs:37-44,
    "crucial for correctness"): a round's output slot takes b verbatim when
    a is exactly zero (an absent row) and a when b is zero, bypassing the GSW
    selection whose key error would otherwise swamp the decode budget.

    One launch of kernel F (csrc/fold_round.cu) per round on a CUDA tensor,
    fold_round_plain on a CPU tensor."""
    num_per = cts.shape[-4]
    if num_per == 1:
        return cts[..., 0, :, :, :]
    vb = _fold_key_dims(params, cts, v_folding, v_folding_neg)
    if cts.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {cts.device}")
    further_dims = params.db_dim_2
    for cur_dim in range(further_dims):
        key = further_dims - 1 - cur_dim
        if cts.device.type == "cuda":
            cts = _fold_round_launch(params, cts, v_folding_neg, v_folding,
                                     key, vb)
        else:
            sel = (slice(None),) * vb + (key,)
            cts = fold_round_plain(params, cts, v_folding_neg[sel],
                                   v_folding[sel])
    return cts[..., 0, :, :, :]


def _key_matrix(k) -> torch.Tensor:
    """The key matrix of a keyed (w, w_shoup) pair or a bare tensor."""
    return k[0] if isinstance(k, tuple) else k


def pack_plain(params: Params, v_ct: torch.Tensor, v_packing) -> torch.Tensor:
    """pack for one (query, instance) in plain PyTorch (the plain versions of
    A, A' and B, never a kernel). v_ct: raw (n*n, 2, 1, z); returns NTT
    (n+1, n, crt, z)."""
    n = params.n
    keys = [_key_matrix(k) for k in v_packing]
    cols = []
    for c in range(n):
        v_int = torch.zeros((n + 1, 1, params.crt_count, params.poly_len),
                            dtype=torch.int32, device=v_ct.device)
        for r in range(n):
            ct = v_ct[r * n + c]
            ct2 = _to_ntt_plain(params, ct[1:2])
            ginv_ntt = _to_ntt_plain(params, gadget_digits(
                params, ct[0:1], params.t_conv, 1))
            if params.version == 0:
                prod = matmul_mod_plain(params, keys[r], ginv_ntt)
                v_int = v_int.clone()
                v_int[1 + r:2 + r] = add_mod(params, v_int[1 + r:2 + r], ct2)
                v_int = add_mod(params, v_int, prod)
            else:
                w_key, w_shift = keys[0], keys[1]
                prod = matmul_mod_plain(params, w_key, ginv_ntt)
                prod = torch.cat([prod[0:1], add_mod(params, prod[1:2], ct2),
                                  prod[2:]])             # (n+1, 1, crt, z)
                for _ in range(r):
                    ginv2 = gadget_digits(
                        params, _from_ntt_plain(params, prod[0:1]),
                        params.t_conv, 1)
                    part1 = matmul_mod_plain(params, w_shift,
                                             _to_ntt_plain(params, ginv2))
                    rest = prod[1:]
                    part2 = torch.cat([torch.zeros_like(prod[0:1]),
                                       rest[-1:], rest[:-1]])
                    prod = add_mod(params, part1, part2)
                v_int = add_mod(params, v_int, prod)
        cols.append(v_int)
    return torch.cat(cols, dim=1)


PACK_MODES = ("ntt", "raw", "words")
_PACK_MAX_SMEM = 227 * 1024


class PackTiling(NamedTuple):
    """How kernel G cuts its work (see csrc/pack.cu): ``cluster`` blocks a
    (query, instance, column), 1 or n (one r a block, the partial sums added
    through distributed shared memory), each of ``pairs`` pairs of 128-thread
    transform groups (a group a CRT channel), which run that many
    independent transforms side by side."""

    pairs: int
    cluster: int


def pack_smem_bytes(params: Params, pairs: int) -> int:
    """Kernel G's dynamic shared memory (csrc/pack.cu smem_bytes): two
    padded exchange buffers a group, the (n+1)-row sum, and for version 1
    the shift steps' row 0 and its composed values."""
    rows = params.n + 1 + (0 if params.version == 0 else 2)
    return 4 * (4 * pairs * core_pad(params.poly_len)
                + rows * 2 * params.poly_len)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of a CUDA card (pack_tiling's one-wave test)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_tiling(params: Params, nq: int, sms: int,
                cluster: int | None = None) -> PackTiling:
    """Kernel G's tiling for a batch of ``nq`` queries on a card of ``sms``
    SMs: as many pairs (up to 4, 1024 threads) as the widest step of its
    chain has independent transforms (1 + t_conv forward transforms a
    round, n + 1 rows at the end) and as fit in shared memory, one block an
    SM; a cluster of n blocks a (query, instance, column) when all the
    clusters' blocks fit one wave, else one block. ``cluster`` overrides
    the form (tests, sweeps)."""
    n = params.n
    pairs = min(4, max(1 + params.t_conv, n + 1))
    while pairs > 1 and pack_smem_bytes(params, pairs) > _PACK_MAX_SMEM:
        pairs -= 1
    if cluster is None:
        cluster = n if nq * params.instances * n * n <= sms else 1
    if pack_smem_bytes(params, pairs) > _PACK_MAX_SMEM \
            or cluster not in (1, n) or cluster > 8:
        raise ValueError(f"pack tiling: {pairs} pairs, cluster {cluster} at "
                         f"n = {n}, version {params.version}")
    return PackTiling(pairs, cluster)


def _pack_launch(params: Params, v_ct: torch.Tensor, v_packings: list,
                 mode: str, plan=None,
                 cluster: int | None = None) -> torch.Tensor:
    """Kernel G (csrc/pack.cu) on v_ct (nq, instances, n*n, 2, 1, z) with one
    key list per query; the keys go in as a table of device pointers. mode
    "ntt", "raw" or "words" (the last with ``plan``, a ResponseEncodePlan of
    ``params``). ``cluster`` overrides :func:`pack_tiling`'s form (tests,
    sweeps)."""
    n, z = params.n, params.poly_len
    nq, inst = v_ct.shape[:2]
    nkeys = n if params.version == 0 else 2
    keys = [[_key_matrix(k) for k in vp[:nkeys]] for vp in v_packings]
    want = (n + 1, params.t_conv, params.crt_count, z)
    if (v_ct.dtype != torch.int64 or tuple(v_ct.shape[2:]) != (n * n, 2, 1, z)
            or params.crt_count != 2 or params.poly_len_log2 != 11
            or len(keys) != nq or mode not in PACK_MODES
            or any(len(ks) != nkeys or k.dtype != torch.int32
                   or tuple(k.shape) != want for ks in keys for k in ks)):
        raise ValueError(f"pack: v_ct {v_ct.dtype} {tuple(v_ct.shape)} with "
                         f"{len(keys)} key lists of (n+1, t_conv, crt, z) "
                         f"int32 matrices, mode {mode!r}")
    num_words, words_args = 0, (0, 0, 0, 0, 0, 0)
    if mode == "words":
        # at z = 2048 every (instance, row, column) segment is whole words:
        # the blocks' word ranges tile the response and no word is padding
        if plan.num_words * 32 != plan.num_bits:
            raise ValueError(f"pack: a response of {plan.num_bits} bits has "
                             f"padding words")
        num_words = plan.num_words
        words_args = (params.modulus, pow(params.modulus, -1, 1 << 32),
                      plan.q2_val, plan.q1_val, plan.q2_bits, plan.q1_bits)
    v_ct = v_ct.contiguous()
    if v_ct.data_ptr() % 16:              # 16-byte loads of int64 pairs
        v_ct = v_ct.clone()
    keys = [[k.contiguous() for k in ks] for ks in keys]
    tb = ntt_tables(params, v_ct.device)
    _build.require_cuda(v_ct, tb, *[k for ks in keys for k in ks])
    tl = pack_tiling(params, nq, _sm_count(v_ct.device), cluster)
    table = torch.tensor([k.data_ptr() for ks in keys for k in ks],
                         dtype=torch.int64).to(v_ct.device)
    shape, dtype = {"ntt": ((nq, inst, n + 1, n, 2, z), torch.int32),
                    "raw": ((nq, inst, n + 1, n, z), torch.int64),
                    "words": ((nq, num_words), torch.int32)}[mode]
    out = torch.empty(shape, dtype=dtype, device=v_ct.device)
    q0, q1 = params.moduli
    _build.launch("pack", "sdk_pack", v_ct.device, v_ct.data_ptr(),
                  table.data_ptr(), tb.data_ptr(), out.data_ptr(),
                  PACK_MODES.index(mode), nq, inst, n, params.t_conv,
                  _get_bits_per(params, params.t_conv), params.version,
                  tl.pairs, tl.cluster, q0, q1, params.inv_q0_mod_q1, num_words,
                  *words_args, _build.stream_of(v_ct))
    return out


def pack_queries_plain(params: Params, v_ct: torch.Tensor, v_packings: list,
                       raw: bool = False) -> torch.Tensor:
    """pack_queries' plain version (pack_plain per (query, instance), and
    with ``raw`` the plain from_ntt) on any device: it never launches a
    kernel."""
    out = torch.stack([
        torch.stack([pack_plain(params, v_ct[i, j], vp)
                     for j in range(v_ct.shape[1])])
        for i, vp in enumerate(v_packings)])
    return _from_ntt_plain(params, out) if raw else out


def pack_queries(params: Params, v_ct: torch.Tensor, v_packings: list,
                 raw: bool = False) -> torch.Tensor:
    """pack for every (query, instance) of a batch: v_ct raw (nq, instances,
    n*n, 2, 1, z), v_packings one key list per query. Returns the packed
    NTT matrices (nq, instances, n+1, n, crt, z) int32, or with ``raw`` their
    from_ntt (nq, instances, n+1, n, z) int64, which kernel G computes in
    the same launch. One launch of kernel G on a CUDA tensor, the plain
    version on a CPU tensor."""
    if v_ct.device.type == "cuda":
        return _pack_launch(params, v_ct, v_packings, "raw" if raw else "ntt")
    if v_ct.device.type != "cpu":
        raise ValueError(f"unsupported device {v_ct.device}")
    return pack_queries_plain(params, v_ct, v_packings, raw)


def pack_encode_plain(params: Params, v_ct: torch.Tensor, v_packings: list,
                      plan) -> torch.Tensor:
    """pack_encode's plain version on any device: pack_queries_plain(raw)
    then plan.encode_plain per query."""
    packed = pack_queries_plain(params, v_ct, v_packings, raw=True)
    return torch.stack([plan.encode_plain(p) for p in packed])


def pack_encode(params: Params, v_ct: torch.Tensor, v_packings: list,
                plan) -> torch.Tensor:
    """The folded cts of a batch to its wire responses: pack, from_ntt and
    the response encode of ``plan`` (a ResponseEncodePlan of ``params``),
    what server_jax.py:398 _pack_encode_impl runs. v_ct raw (nq, instances,
    n*n, 2, 1, z), v_packings one key list per query; returns (nq,
    plan.num_words) int32 words. One launch of kernel G in its out_words
    mode on a CUDA tensor, the plain version on a CPU tensor."""
    if v_ct.device.type == "cuda":
        return _pack_launch(params, v_ct, v_packings, "words", plan)
    if v_ct.device.type != "cpu":
        raise ValueError(f"unsupported device {v_ct.device}")
    return pack_encode_plain(params, v_ct, v_packings, plan)


def pack(params: Params, v_ct: torch.Tensor, v_packing) -> torch.Tensor:
    """v_ct: raw (n*n, 2, 1, z); v_packing: list of n keyed (n+1, t_conv)
    matrices (version 0) or [w_key, w_shift] (version 1, pack.rs:46-100).
    Returns packed NTT (n+1, n, crt, z)."""
    return pack_queries(params, v_ct[None, None], [v_packing])[0, 0]
