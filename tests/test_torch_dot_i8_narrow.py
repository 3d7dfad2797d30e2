"""Kernel K's narrow form (csrc/dp_dot_i8.cu: the answer's hint product
a_2 = digits @ q2, N <= 8) modelled in numpy, step by step as the kernel
runs it.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).
Here its arithmetic is rebuilt from its own index expressions: the grid of
(K splits) x (row groups) that launch_narrow sizes from the occupancy
query, every split at most 65,536 k; each block's slices of b staged as
[k][8] words with the rows of each aligned four rotated, columns past N
and rows past K zero; the lanes' 16-byte loads of the A rows (rows past M
and k past K as zeros; the bytes past K in a row are garbage), the words
each lane reads from a slice and their PRMT byte transpose into the four
planes' B registers, the pair form's a' / x split, an m16n8k32 s8 x u8
product emulated from the PTX fragment layouts (held inside int32 at every
product of a split), the epilogue's plane combine and add row, and the
splits' partial sums added mod 2^32 in a shuffled order. The model is held
against the JAX package's ``_dot_i8_u32`` / ``_dot_i8pair_u32`` where their
128 * 127 * K < 2^31 holds, and against the port's plain version past it,
with the worst values. Integer results: the tolerance is 0. A CPU tensor
never reaches a launch.
"""

import jax
import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import server_jax as sj
from sdk_tpu_torch import _build
from sdk_tpu_torch.doublepir import server_torch as st
from sdk_tpu_torch.ops.modops import u32_bits

from test_torch_dot_i8_tiling import (G, M32, T, add_row, byte,
                                      byte_planes, mma, plain, u32)

torch.set_num_threads(1)

# csrc/dp_dot_i8.cu, the narrow form
THREADS, WARPS, MT = 256, 8, 2      # threads, warps a block; m16 tiles a warp
ROW_WARPS = WARPS // MT             # warps along the rows, times MT along k
ROWS = 16 * MT * ROW_WARPS          # rows a block
UNIT_K = 256                        # k a unit: its A pieces and slice of b
PARTS = UNIT_K // 64                # 64-k parts of a unit
WARP_PARTS = PARTS // MT            # parts of a unit a warp takes
RING = 3                            # units of the cp.async ring
MAX_RUN_K = 65536
SMS, BLOCKS_PER_SM = 132, 1         # the H100's SMs; the form's occupancy
SMEM_PER_BLOCK = 232448             # bytes a block can use on Hopper


def grid(M: int, K: int, sms: int = SMS, bps: int = BLOCKS_PER_SM):
    """launch_narrow's (splits, row groups, k a split)."""
    groups = -(-M // ROWS)
    units = -(-K // UNIT_K)
    splits = max(sms * bps // groups, -(-K // MAX_RUN_K))
    splits = min(splits, units)
    per = -(-units // splits)
    return -(-units // per), groups, per * UNIT_K


def b_row(k):
    return (k & ~3) | ((k + (k >> 4)) & 3)


def b_offsets():
    """The kernel's b_ofs[e] by lane: word e of a k step, k 16t + (e & 4)
    + ((e + t) & 3) rows into a 64-k part of the slice, column g."""
    return [(16 * T + (e & 4) + ((e + T) & 3)) * 8 + G for e in range(8)]


class Operands:
    """The kernel's view of its inputs: ``a`` planes in rows of lda bytes
    whose bytes past K are garbage, b (K, N) u32 as it is."""

    def __init__(self, planes, b, rng):
        M, K = planes[0].shape
        self.M, self.K, self.N = M, K, b.shape[1]
        self.lda = -(-K // 16) * 16
        self.a = []
        for pl in planes:
            buf = rng.integers(0, 256, (M, self.lda)).astype(np.uint8)
            buf[:, :K] = pl.view(np.uint8)
            self.a.append(buf)
        self.b = b


def stage_b(op: Operands, k0: int, vec: bool) -> np.ndarray:
    """A unit's slice of b as the kernel's issue copies it: copy e = tid +
    THREADS * round (16-byte chunks (k, ch) with ``vec``, else words (k,
    n)) into row b_row(k); (UNIT_K * 8,) words, each written exactly
    once."""
    per = 2 if vec else 8
    e = np.arange(UNIT_K * per)
    tid, rnd = e % THREADS, e // THREADS
    assert np.array_equal(tid + THREADS * rnd, e)
    width = 4 if vec else 1
    kk, c = e // per, e % per
    col = width * c[:, None] + np.arange(width)
    ok = ((k0 + kk < op.K) & (width * c < op.N))[:, None] & (col < op.N)
    src = op.b[np.where(ok, k0 + kk[:, None], 0), np.where(ok, col, 0)]
    dst = b_row(kk)[:, None] * 8 + col
    s = np.zeros(UNIT_K * 8, np.uint32)
    s[dst] = np.where(ok, src, 0)
    assert np.array_equal(np.bincount(dst.ravel(), minlength=UNIT_K * 8),
                          np.ones(UNIT_K * 8, np.int64))
    return s


def warp_parts(warp: int) -> range:
    """The parts of each unit warp (kh, row warp) takes: kh * WARP_PARTS .."""
    kh = warp // ROW_WARPS
    return range(kh * WARP_PARTS, (kh + 1) * WARP_PARTS)


def warp_row(group: int, warp: int) -> int:
    """The first of the warp's 16 MT rows."""
    return group * ROWS + (warp % ROW_WARPS) * 16 * MT


def lane_loads(op: Operands, plane: int, m0: int, kbeg: int, n_units: int,
               parts):
    """The 16-byte copies of a warp at rows m0 .. m0 + 16 MT - 1: (tile i,
    half h, part c) -> (units, lane, 16) bytes, row m0 + 16i + g + 8h, k
    kbeg + 256u + 64c + 16t .. + 15 for the warp's parts c; zeros where
    the row is past M or the copy starts past K."""
    out = {}
    u = np.arange(n_units)[:, None]
    for c in parts:
        k = kbeg + UNIT_K * u + 64 * c + 16 * T[None, :]
        for i in range(MT):
            for h in range(2):
                row = m0 + 16 * i + G + 8 * h
                ok = (row < op.M)[None, :] & (k < op.K)
                src = op.a[plane][np.where(row < op.M, row, 0)[None, :, None],
                                  np.where(ok, k, 0)[..., None]
                                  + np.arange(16)]
                src[~ok] = 0
                out[i, h, c] = src
    return out


def words(b, off):
    return sum(b[..., off + e].astype(np.uint32) << np.uint32(8 * e)
               for e in range(4)).astype(np.uint32)


def block_partials(op: Operands, split: int, group: int, split_k: int,
                   add, vec: bool):
    """The (row, column, value) atomics of one block."""
    pair = len(op.a) == 2
    kbeg = split * split_k
    kend = min(op.K, kbeg + split_k)
    n_units = -(-(kend - kbeg) // UNIT_K)
    unit_b = np.stack([stage_b(op, kbeg + u * UNIT_K, vec)
                       for u in range(n_units)])
    ofs = b_offsets()
    bregs = {}                       # by (part c, step h): plane j -> (b0, b1)
    for c in range(PARTS):
        for h in range(2):
            w = [unit_b[:, 512 * c + 64 * h + ofs[e]] for e in range(8)]
            bregs[c, h] = list(zip(byte_planes(*w[:4]), byte_planes(*w[4:])))
    parts = []
    for warp in range(WARPS):
        m0 = warp_row(group, warp)
        if m0 >= op.M:
            continue
        parts_w = warp_parts(warp)
        loads = [lane_loads(op, p, m0, kbeg, n_units, parts_w)
                 for p in range(len(op.a))]
        for i in range(MT):
            if m0 + 16 * i >= op.M:               # no row of the tile stored
                continue
            seq = [[] for _ in range(4)]          # accumulator j's products
            for c in parts_w:
                for h in range(2):
                    r0, r1 = loads[0][i, 0, c], loads[0][i, 1, c]
                    a = np.stack([words(r0, 8 * h), words(r1, 8 * h),
                                  words(r0, 8 * h + 4), words(r1, 8 * h + 4)],
                                 -1)
                    if pair:
                        q0, q1 = loads[1][i, 0, c], loads[1][i, 1, c]
                        hw = np.stack([words(q0, 8 * h), words(q1, 8 * h),
                                       words(q0, 8 * h + 4),
                                       words(q1, 8 * h + 4)], -1)
                        a = a | ((hw & np.uint32(0x01010101)) << np.uint32(7))
                        x = ((hw + np.uint32(0x01010101)) >> np.uint32(1)) \
                            & np.uint32(0x7F7F7F7F)
                        for j in range(3):
                            seq[j + 1].append(((c, h, 0),
                                               mma(x, *bregs[c, h][j])))
                    for j in range(4):
                        seq[j].append(((c, h, 1), mma(a, *bregs[c, h][j])))
            val = np.zeros((32, 4), np.uint64)
            for j in range(4):
                # program order: unit, part c, step h, the x before the a
                prods = sorted(seq[j], key=lambda s: s[0])
                run = np.stack([p for _, p in prods], 1).reshape(-1, 32, 4)
                csum = np.cumsum(run, axis=0)
                assert csum.min() >= -2 ** 31 and csum.max() < 2 ** 31
                val += (csum[-1].astype(np.uint64) & np.uint64(M32)) \
                    << np.uint64(8 * j)
            for hh in range(2):
                rows = m0 + 16 * i + G + 8 * hh
                for e in range(2):
                    cols = 2 * T + e
                    ok = (rows < op.M) & (cols < op.N)
                    v = val[:, 2 * hh + e]
                    if split == 0 and warp < ROW_WARPS and add is not None:
                        v = v + add[np.minimum(cols, op.N - 1)]
                    for r, c, x in zip(rows[ok], cols[ok], v[ok]):
                        parts.append((r, c, int(x) & M32))
    return parts


def model(op: Operands, add, rng, sms=SMS, bps=BLOCKS_PER_SM) -> np.ndarray:
    """out (M, N) u32 as the narrow launch computes it: a memset output,
    every block's atomics added in a shuffled order."""
    splits, groups, split_k = grid(op.M, op.K, sms, bps)
    assert split_k <= MAX_RUN_K and (splits - 1) * split_k < op.K
    vec = op.N % 4 == 0
    parts = []
    for group in range(groups):
        for split in range(splits):
            parts += block_partials(op, split, group, split_k,
                                    None if add is None
                                    else add.astype(np.uint64), vec)
    out = np.zeros((op.M, op.N), np.uint64)
    for k in rng.permutation(len(parts)):
        r, c, v = parts[k]
        out[r, c] = (out[r, c] + v) & M32
    return out.astype(np.uint32)


def planes_of(rng, M, K, pair):
    if pair:
        return [rng.integers(0, 128, (M, K)).astype(np.int8),
                rng.integers(0, 4, (M, K)).astype(np.int8)]
    return [rng.integers(-128, 128, (M, K)).astype(np.int8)]


def test_grid_takes_every_row_and_k_once():
    """Through the grid, the warps' tiles and parts, the lanes' copies and
    the MMA's k slots (lane t, part c, step h, byte e: k 256u + 64c + 16t +
    8h + e of the split), each (row, k) of a ragged launch is taken exactly
    once; the production a_2 grid is 4 splits of 23,296 k over 32 row
    groups (128 blocks, one an SM)."""
    for M, K, sms, bps in ((300, 7001, SMS, BLOCKS_PER_SM),
                           (37, 1003, SMS, BLOCKS_PER_SM),
                           (40, 140000, 1, 1), (17, 33, 4, 2),
                           (300, 4099, 8, 1)):
        splits, groups, split_k = grid(M, K, sms, bps)
        count = np.zeros((M, K), np.int64)
        for group in range(groups):
            for split in range(splits):
                kbeg = split * split_k
                kend = min(K, kbeg + split_k)
                n_units = -(-(kend - kbeg) // UNIT_K)
                u = np.arange(n_units)[:, None, None, None, None]
                k = kbeg + UNIT_K * u \
                    + 64 * np.arange(PARTS)[None, :, None, None, None] \
                    + 16 * T[None, None, :, None, None] \
                    + 8 * np.arange(2)[None, None, None, :, None] \
                    + np.arange(8)[None, None, None, None, :]
                for warp in range(WARPS):
                    kw = k[:, list(warp_parts(warp))]
                    for i in range(MT):
                        for hh in range(2):
                            row = warp_row(group, warp) + 16 * i + G + 8 * hh
                            r = np.broadcast_to(
                                row[None, None, :, None, None], kw.shape)
                            ok = (r < M) & (kw < K)
                            np.add.at(count, (r[ok], kw[ok]), 1)
        assert (count == 1).all(), (M, K)
    assert grid(4096, 92682) == (4, 32, 23296)
    assert grid(4096, 92682)[0] * 32 <= SMS * BLOCKS_PER_SM


def test_lanes_read_their_b_words_from_the_slice():
    """Lane (g, t)'s word e of step h of part c, read at 512c + 64h +
    b_ofs[e] of a unit's slice, is b[64c + 16t + 8h + e, g] of the unit
    (zero past N), in both staging paths; the transpose gives each plane's
    B registers."""
    rng = np.random.default_rng(1)
    for N in (8, 4, 3, 1):
        b = u32(rng, (UNIT_K, N))
        op = Operands([np.zeros((1, UNIT_K), np.int8)], b, rng)
        for vec in ((False, True) if N % 4 == 0 else (False,)):
            s = stage_b(op, 0, vec)
            bp = np.zeros((UNIT_K, 8), np.uint32)
            bp[:, :N] = b
            for u in range(PARTS):
                for h in range(2):
                    w = [s[512 * u + o + 64 * h] for o in b_offsets()]
                    for e in range(8):
                        np.testing.assert_array_equal(
                            w[e], bp[64 * u + 16 * T + 8 * h + e, G])
                    lo, hi = byte_planes(*w[:4]), byte_planes(*w[4:])
                    for j in range(4):
                        for e in range(4):
                            k = 64 * u + 16 * T + 8 * h + e
                            np.testing.assert_array_equal(
                                byte(lo[j], e, False), (bp[k, G] >> 8 * j) & 255)
                            np.testing.assert_array_equal(
                                byte(hi[j], e, False),
                                (bp[k + 4, G] >> 8 * j) & 255)


def test_slice_reads_hit_32_banks():
    """Each of a warp's word loads from a slice (fixed part c, step h and
    word e) touches 32 distinct banks; a ring slot (the unit's A pieces
    and its slice of b), three of them, fits one block's shared memory."""
    for c in range(PARTS):
        for h in range(2):
            for o in b_offsets():
                assert len(set(((512 * c + o + 64 * h) % 32).tolist())) == 32
    for planes in (1, 2):
        slot = MT * planes * 2 * WARP_PARTS * THREADS * 16 + UNIT_K * 8 * 4
        assert slot % 16 == 0 and RING * slot <= SMEM_PER_BLOCK


# (M, K, N, SMs): ragged rows and K, one row group and three; every N at
# one shape; three row groups on an 8-SM card (2 splits of 8 units)
CASES = [(37, 1003, n, SMS) for n in range(1, 9)] + [
    (300, 4099, 3, 8), (300, 4099, 8, 8), (9, 33, 1, SMS), (9, 33, 4, SMS)]


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
@pytest.mark.parametrize("case", CASES, ids=lambda s: "M{}_K{}_N{}".format(*s))
def test_model_matches_jax(case, pair):
    """The model of the narrow form against the JAX device program it
    replaces (where 128 * 127 * K < 2^31), with and without the add row."""
    M, K, N, sms = case
    rng = np.random.default_rng(3 + N)
    b = u32(rng, (K, N))
    planes = planes_of(rng, M, K, pair)
    if pair:
        want = np.asarray(jax.jit(sj._dot_i8pair_u32)(*planes, b))
        c = -(464 // 2)
    else:
        want = np.asarray(jax.jit(sj._dot_i8_u32)(planes[0], b))
        c = 128 - 464 // 2
    op = Operands(planes, b, rng)
    np.testing.assert_array_equal(model(op, None, rng, sms), want)
    add = add_row(b, c)
    want_c = (want.astype(np.uint64) + add[None, :]) & np.uint64(M32)
    np.testing.assert_array_equal(model(op, add, rng, sms), want_c)
    np.testing.assert_array_equal(want_c.astype(np.uint32), plain(planes, b, c))


def worst_planes(M: int, K: int, pair: bool):
    """The largest per-k contributions: the pair form's (a_lo, a_hi) of
    (127, 2) (a' = 127, x = 1: +32,640 at b = 255), (127, 3), (0, 1) (a' =
    -128, x = 1) and (127, 0) by row; one plane at -128."""
    if not pair:
        return [np.full((M, K), -128, np.int8)]
    lo_hi = np.array([(127, 2), (127, 3), (0, 1), (127, 0)], np.int8)
    rows = lo_hi[np.arange(M) % 4]
    return [np.repeat(rows[:, :1], K, 1), np.repeat(rows[:, 1:], K, 1)]


@pytest.mark.parametrize("form", ["worst", "random"])
@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
def test_model_past_one_run(pair, form):
    """K = 131,000 on a one-block card: two splits, the first a whole run of
    65,536 k, past the JAX program's bound; at the worst values (b =
    0xFFFFFFFF) the model's int32 check holds only because no split is
    longer than a run. Against the port's plain version."""
    M, K, N = 5, 131000, 3
    rng = np.random.default_rng(4)
    if form == "worst":
        b = np.full((K, N), M32, np.uint32)
        planes = worst_planes(M, K, pair)
    else:
        b = u32(rng, (K, N))
        planes = planes_of(rng, M, K, pair)
    assert grid(M, K, 1, 1) == (2, 1, MAX_RUN_K)
    c = -(464 // 2) if pair else 128 - 464 // 2
    op = Operands(planes, b, rng)
    np.testing.assert_array_equal(model(op, add_row(b, c), rng, 1, 1),
                                  plain(planes, b, c))
    # one k adds at most 32,640 in size to an accumulator: a run is exact
    assert 32640 * MAX_RUN_K < 2 ** 31


def test_routing_on_the_cpu(monkeypatch):
    """On CPU tensors no kernel is built or launched: ``_dot`` runs the
    plain version. The launch wrappers refuse what their entries do not
    take before any launch: CPU tensors, more than 8 columns in the narrow
    form, a second plane in the select form."""
    def no_build():
        raise AssertionError("a kernel was built for CPU tensors")

    monkeypatch.setattr(_build, "lib", no_build)
    rng = np.random.default_rng(6)
    M, K = 20, 100
    lo = torch.from_numpy(rng.integers(0, 128, (M, K)).astype(np.int8))
    hi = torch.from_numpy(rng.integers(0, 4, (M, K)).astype(np.int8))
    before = dict(_build.LAUNCHES)
    for N in (1, 8):
        b = u32_bits(u32(rng, (K, N)), "cpu")
        got = st._dot(lo, hi, b, 5, False)
        assert torch.equal(got, st._dot_plain(lo, hi, b, 5, False))
        with pytest.raises(ValueError):
            st._dot_narrow_launch(lo, hi, b, 5)
    with pytest.raises(ValueError, match="8 columns"):
        st._dot_narrow_launch(lo, hi, u32_bits(u32(rng, (K, 9)), "cpu"), 0)
    with pytest.raises(ValueError, match="one plane"):
        st._dot_launch(lo, hi, u32_bits(u32(rng, (K, 2)), "cpu"), 0, True)
    assert _build.LAUNCHES == before
