"""Kernel K's tiled form (csrc/dp_dot_i8.cu: the hint setup's DB @ A1 and
digits @ A2) modelled in numpy, step by step as the kernel runs it.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).
Here its arithmetic is rebuilt from its own index expressions: each
stage's cp.async copies into shared memory (rows past M, k past K and
columns past ldb as zeros; the bytes past K in a row are garbage), the b
chunk swizzle, the lanes' fragment loads, the PRMT byte transpose of four
u32 words into the four byte planes' B registers, the pair form's a' / x
split, an m16n8k32 s8 x u8 product emulated from the PTX fragment layouts,
the s32 accumulators restarted every 65,536 k (held inside int32 at every
product) and folded into the outputs with wrapping u32 adds, and the plane
combine plus the ``add`` row. The model is held against the JAX package's
``_dot_i8_u32`` / ``_dot_i8pair_u32`` where their 128 * 127 * K < 2^31
holds, and against the port's plain version past it, with the worst
values. Integer results: the tolerance is 0. Through the kernel's own
block, warp and lane arithmetic, every (m, n) is stored exactly once, and a
CPU tensor never reaches the launch.
"""

import jax
import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import server_jax as sj
from sdk_tpu_torch import _build
from sdk_tpu_torch.doublepir import server_torch as st
from sdk_tpu_torch.ops.modops import u32_bits

torch.set_num_threads(1)

# csrc/dp_dot_i8.cu
WARPS, MT, NT = 8, 4, 2            # warps a block; m16 / n8 tiles a warp
THREADS = 32 * WARPS
BM, BN = 16 * MT, 8 * NT * WARPS   # block tile: the warps side by side on N
STEP_K, STAGE_K, STAGES = 32, 128, 2
STAGE_STEPS = STAGE_K // STEP_K
RESTART_STEPS = 2048
SMEM_PER_BLOCK = 232448            # bytes a block can use on Hopper
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
M32 = 0xFFFFFFFF


def tiles(M: int, N: int) -> tuple[int, int]:
    """(m tiles, n tiles) of the launch's grid."""
    return -(-M // BM), -(-N // BN)


def block_tile(bid: int, M: int, N: int) -> tuple[int, int]:
    """(first row, first column) of block ``bid``: the kernel's block
    order, n tiles fastest."""
    return bid // tiles(M, N)[1] * BM, bid % tiles(M, N)[1] * BN


def warp_columns(warp: int) -> int:
    """The first of the warp's 16 u32 columns in the block tile (nw)."""
    return warp * 8 * NT


def byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4i) & 7
    of the eight bytes x, y (selectors below 8, as the kernel's)."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        s = (sel >> (4 * i)) & 7
        out |= ((src >> np.uint64(8 * s)) & np.uint64(255)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def byte_planes(w0, w1, w2, w3):
    """The kernel's byte_planes: 8 PRMTs, four words -> four planes."""
    t0, t1 = byte_perm(w0, w1, 0x5140), byte_perm(w0, w1, 0x7362)
    t2, t3 = byte_perm(w2, w3, 0x5140), byte_perm(w2, w3, 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def byte(w, e: int, signed: bool):
    v = (np.asarray(w, np.int64) >> (8 * e)) & 255
    return v - ((v >> 7) << 8) if signed else v


def mma(a, b0, b1):
    """mma.sync.m16n8k32.row.col.s32.s8.u8: a (..., 32, 4) and b0, b1
    (..., 32) registers by lane -> the product's (..., 32, 4) registers,
    from the PTX fragment layouts (A: row g (+8 for a1, a3), k 4t .. 4t+3
    (+16 for a2, a3); B: column g, k 4t .. 4t+3 (+16 for b1); D: row g (+8
    for d2, d3), column 2t (+1 for d1, d3))."""
    lead = a.shape[:-2]
    A = np.zeros(lead + (16, 32))
    B = np.zeros(lead + (32, 8))
    for r in range(4):
        for e in range(4):
            A[..., G + 8 * (r & 1), 4 * T + 16 * (r >> 1) + e] = \
                byte(a[..., r], e, True)
    for r, reg in enumerate((b0, b1)):
        for e in range(4):
            B[..., 4 * T + 16 * r + e, G] = byte(reg, e, False)
    D = np.rint(A @ B).astype(np.int64)       # exact: |sums| < 2^53
    return np.stack([D[..., G, 2 * T], D[..., G, 2 * T + 1],
                     D[..., G + 8, 2 * T], D[..., G + 8, 2 * T + 1]], -1)


def b_chunk(k, c):
    return c ^ (((k >> 3) & 3) << 1)


def words(buf, off):
    """Little-endian u32 at byte offsets ``off`` of uint8 rows ``buf``."""
    return sum(buf[..., off + e].astype(np.uint32) << np.uint32(8 * e)
               for e in range(4)).astype(np.uint32)


class Operands:
    """The kernel's view of its inputs: ``a`` planes in rows of lda bytes
    whose bytes past K are garbage, b in rows of ldb words (columns N ..
    ldb zero, as the wrapper pads them)."""

    def __init__(self, planes, b, rng):
        M, K = planes[0].shape
        self.M, self.K, self.N = M, K, b.shape[1]
        self.lda = -(-K // 16) * 16
        self.a = []
        for pl in planes:
            buf = rng.integers(0, 256, (M, self.lda)).astype(np.uint8)
            buf[:, :K] = pl.view(np.uint8)
            self.a.append(buf)
        self.ldb = -(-self.N // 4) * 4
        self.b = np.zeros((K, self.ldb), np.uint32)
        self.b[:, :self.N] = b


def stage_smem(op: Operands, m0: int, n0: int):
    """Every stage of one block as its load_stage copies it: the a planes
    (n_kt, planes, STAGE_STEPS * BM * 32) bytes and b (n_kt, STAGE_K * BN)
    words."""
    n_kt = -(-op.K // STAGE_K)
    kt = np.arange(n_kt)[:, None]
    idx = np.arange(BM * (STAGE_K // 16))[None, :]
    row, piece = idx // (STAGE_K // 16), idx % (STAGE_K // 16)
    k = kt * STAGE_K + 16 * piece
    m = m0 + row
    ok = (m < op.M) & (k < op.K)
    dst = ((piece >> 1) * BM + row) * STEP_K + 16 * (piece & 1)
    a_s = np.zeros((n_kt, len(op.a), STAGE_STEPS * BM * STEP_K), np.uint8)
    for p, buf in enumerate(op.a):
        src = buf[np.where(ok, m, 0)[..., None],
                  np.where(ok, k, 0)[..., None] + np.arange(16)]
        src[~ok] = 0
        a_s[kt[..., None], p, dst[..., None] + np.arange(16)] = src
    idx = np.arange(STAGE_K * (BN // 4))[None, :]
    kk, c = idx // (BN // 4), idx % (BN // 4)
    k = kt * STAGE_K + kk
    n = n0 + 4 * c
    ok = (k < op.K) & (n < op.ldb)
    src = op.b[np.where(ok, k, 0)[..., None],
               np.where(ok, n, 0)[..., None] + np.arange(4)]
    src[~ok] = 0
    b_s = np.zeros((n_kt, STAGE_K * BN), np.uint32)
    b_s[kt[..., None], (kk * BN + 4 * b_chunk(kk, c))[..., None]
        + np.arange(4)] = src
    return a_s, b_s


def b_offset(nw: int, u: int):
    """The kernel's b_ofs[u] by lane: word 8t of column nw + 8u + g, whose
    chunk row 8t swizzles by 2t."""
    n = nw + 8 * u + G
    return 8 * T * BN + 4 * ((n >> 2) ^ (T << 1)) + (n & 3)


def b_registers(b_s, nw: int, u: int):
    """The four planes' (b0, b1) of n8 tile u of the warp at column nw, by
    k32 step and lane: lane (g, t) reads words k = 8t .. 8t+7 of column
    nw + 8u + g (b_ofs[u] + (32 ks + i) BN) and transposes them."""
    w = []
    for i in range(8):
        ofs = b_offset(nw, u) \
            + (np.arange(STAGE_STEPS)[:, None] * STEP_K + i) * BN
        w.append(b_s[:, ofs].reshape(-1, 32))
    return list(zip(byte_planes(*w[:4]), byte_planes(*w[4:])))


def a_registers(a_s, p: int, row0: int):
    """a0 .. a3 of the m16 tile at row0, by k32 step and lane: rows g and
    g + 8, bytes 8t .. 8t+7 of the step's 32, as two 8-byte loads."""
    regs = []
    for r in (0, 8):
        off = (np.arange(STAGE_STEPS)[:, None] * BM + row0 + r + G) * STEP_K \
            + 8 * T
        row = a_s[:, p]
        regs.append((words(row, off).reshape(-1, 32),
                     words(row, off + 4).reshape(-1, 32)))
    (r0x, r0y), (r1x, r1y) = regs
    return np.stack([r0x, r1x, r0y, r1y], -1)


def runs(contribs):
    """The s32 accumulator over the products ``contribs`` (a list, in program
    order, of (steps, 32, 4)), restarted every RESTART_STEPS steps: the
    value of each run, checked inside int32 after every product."""
    seq = np.stack(contribs, 1)               # (steps, products, 32, 4)
    out = []
    for s0 in range(0, seq.shape[0], RESTART_STEPS):
        part = np.cumsum(seq[s0:s0 + RESTART_STEPS].reshape(
            -1, 32, 4), axis=0)
        assert part.min() >= -2 ** 31 and part.max() < 2 ** 31
        out.append(part[-1])
    return out


def model(op: Operands, add) -> np.ndarray:
    """out (M, N) u32 as the tiled kernel computes and stores it."""
    pair = len(op.a) == 2
    out = np.zeros((op.M, op.N), np.uint64)
    mt, nt = tiles(op.M, op.N)
    add = np.zeros(op.N, np.uint64) if add is None else add.astype(np.uint64)
    for bid in range(mt * nt):
        m0, n0 = block_tile(bid, op.M, op.N)
        a_s = b_s = None
        for warp in range(WARPS):
            nw = warp_columns(warp)
            for u in range(NT):
                cols = n0 + nw + 8 * u + 2 * T
                if cols.min() >= op.N:
                    continue
                if a_s is None:
                    a_s, b_s = stage_smem(op, m0, n0)
                bp = b_registers(b_s, nw, u)
                for i in range(MT):
                    row0 = 16 * i
                    if m0 + row0 >= op.M:
                        continue
                    a = a_registers(a_s, 0, row0)
                    acc = [[] for _ in range(4)]
                    if pair:
                        hw = a_registers(a_s, 1, row0)
                        a = a | ((hw & np.uint32(0x01010101)) << np.uint32(7))
                        x = ((hw + np.uint32(0x01010101)) >> np.uint32(1)) \
                            & np.uint32(0x7F7F7F7F)
                        for j in range(3):
                            acc[j + 1].append(mma(x, *bp[j]))
                    for j in range(4):
                        acc[j].append(mma(a, *bp[j]))
                    folds = zip(*[runs(c) for c in acc])
                    val = np.zeros((32, 4), np.uint64)
                    for f, run in enumerate(folds):
                        v = sum((r.astype(np.uint64) & np.uint64(M32))
                                << np.uint64(8 * j) for j, r in enumerate(run))
                        val = (val + v) & np.uint64(M32)
                    for h in (0, 1):
                        rows = m0 + row0 + G + 8 * h
                        for e in (0, 1):
                            c = cols + e
                            ok = (rows < op.M) & (c < op.N)
                            out[rows[ok], c[ok]] = \
                                (add[c[ok]] + val[ok, 2 * h + e]) \
                                & np.uint64(M32)
    return out.astype(np.uint32)


def u32(rng, shape):
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    x.flat[0] = M32
    return x


def plain(planes, b, c: int = 0) -> np.ndarray:
    lo = torch.from_numpy(planes[0])
    hi = torch.from_numpy(planes[1]) if len(planes) == 2 else None
    return st._dot_plain(lo, hi, u32_bits(b, "cpu"), c, False).numpy() \
        .view(np.uint32)


def add_row(b, c: int):
    return (np.uint64(c & M32) * b.astype(np.uint64).sum(0)) \
        & np.uint64(M32) if c else None


def test_byte_planes_give_each_lanes_b_registers():
    """Lane (g, t)'s b0 / b1 of plane j hold byte j of b[k, n] for k = 8t ..
    8t+3 / 8t+4 .. 8t+7 of the step, column g of the tile: the B fragment
    of b_j with the kernel's k order, read from the swizzled stage."""
    rng = np.random.default_rng(1)
    K, N = STAGE_K, 128
    b = u32(rng, (K, N))
    op = Operands([rng.integers(-128, 128, (1, K)).astype(np.int8)], b, rng)
    _, b_s = stage_smem(op, 0, 0)
    for nw in map(warp_columns, range(WARPS)):
        for u in range(NT):
            bp = b_registers(b_s, nw, u)
            for step in range(STAGE_STEPS):
                for j in range(4):
                    for r in range(2):
                        for e in range(4):
                            k = step * STEP_K + 8 * T + 4 * r + e
                            want = (b[k, nw + 8 * u + G] >> (8 * j)) & 255
                            got = byte(bp[j][r][step], e, False)
                            np.testing.assert_array_equal(got, want)


def test_stage_copies_cover_the_stage_once():
    """Through load_stage's thread arithmetic (a thread's A pieces kAR rows
    apart in one 16-byte column, its b chunks kBR rows apart in one chunk
    column), each (row, piece) of A and (k, chunk) of b is copied by exactly
    one (thread, round), and b_ofs reads each word where the swizzled copy
    wrote it."""
    P, BC = STAGE_K // 16, BN // 4
    AR, BR = THREADS // P, THREADS // BC
    tid = np.arange(THREADS)
    a = np.zeros((BM, P), np.int64)
    for q in range(BM // AR):
        np.add.at(a, (tid // P + q * AR, tid % P), 1)
    assert (a == 1).all()
    b = np.zeros((STAGE_K, BC), np.int64)
    for q in range(STAGE_K // BR):
        np.add.at(b, (tid // BC + q * BR, tid % BC), 1)
    assert (b == 1).all()
    for nw in map(warp_columns, range(WARPS)):
        for u in range(NT):
            for ks in range(STAGE_STEPS):
                for i in range(8):
                    k = ks * STEP_K + 8 * T + i
                    n = nw + 8 * u + G
                    np.testing.assert_array_equal(
                        b_offset(nw, u) + (ks * STEP_K + i) * BN,
                        k * BN + 4 * b_chunk(k, n >> 2) + (n & 3))


def test_b_stage_reads_hit_32_banks():
    """Each of a warp's word loads from the b stage (fixed i, u) touches 32
    distinct banks; each 8-byte a load's half warp too."""
    for nw in map(warp_columns, range(WARPS)):
        for u in range(NT):
            n = nw + 8 * u + G
            for ks in range(STAGE_STEPS):
                for i in range(8):
                    k = ks * STEP_K + 8 * T + i
                    word = k * BN + 4 * b_chunk(k, n >> 2) + (n & 3)
                    assert len(set(word % 32)) == 32
    for half in (LANE < 16, LANE >= 16):
        for row0 in range(0, BM, 16):
            for r in (0, 8):
                w = ((row0 + r + G) * STEP_K + 8 * T) // 4
                banks = np.concatenate([w, w + 1])[np.tile(half, 2)] % 32
                assert len(set(banks)) == 32


def test_mma_emulation_is_the_product_over_a_k32_step():
    """The emulated m16n8k32 with the kernel's k order is A @ B over the
    step's 32 k, whatever slot each k sits in."""
    rng = np.random.default_rng(2)
    A = rng.integers(-128, 128, (16, 32))
    B = rng.integers(0, 256, (32, 8))
    # the kernel's slots: lane t's a0 / b0 hold k 8t .. 8t+3, a2 / b1 8t+4 ..
    def pack(vals):
        return sum((np.asarray(v, np.int64) & 255) << (8 * e)
                   for e, v in enumerate(vals)).astype(np.uint32)
    a = np.stack([pack([A[G + 8 * (r & 1), 8 * T + 4 * (r >> 1) + e]
                        for e in range(4)]) for r in range(4)], -1)
    b0 = pack([B[8 * T + e, G] for e in range(4)])
    b1 = pack([B[8 * T + 4 + e, G] for e in range(4)])
    d = mma(a, b0, b1)
    D = A @ B
    np.testing.assert_array_equal(d, np.stack(
        [D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T], D[G + 8, 2 * T + 1]],
        -1))


def test_pair_split_is_exact():
    """a = lo + 128 hi = a' + 256 x for every lo in [0, 128), hi in [0, 4),
    with a' = the byte lo | (hi & 1) << 7 read as s8 and x = (hi + 1) >> 1,
    four bytes to a register as the kernel computes them."""
    lo, hi = np.meshgrid(np.arange(128), np.arange(4))
    lo, hi = lo.ravel(), hi.ravel()
    pad = (-lo.size) % 4
    lo_w = np.pad(lo, (0, pad)).reshape(-1, 4)
    hi_w = np.pad(hi, (0, pad)).reshape(-1, 4)
    lw = sum(lo_w[:, e].astype(np.uint32) << np.uint32(8 * e) for e in range(4))
    hw = sum(hi_w[:, e].astype(np.uint32) << np.uint32(8 * e) for e in range(4))
    aw = lw | ((hw & np.uint32(0x01010101)) << np.uint32(7))
    xw = ((hw + np.uint32(0x01010101)) >> np.uint32(1)) & np.uint32(0x7F7F7F7F)
    for e in range(4):
        a = byte(aw, e, True)
        x = byte(xw, e, True)
        np.testing.assert_array_equal(a + 256 * x, lo_w[:, e] + 128 * hi_w[:, e])
        assert x.min() >= 0 and x.max() <= 2


# (M, K, N): ragged everywhere, N of the tests and of the setup's H1
SMALL = [(37, 1003, 40), (131, 1003, 136), (70, 64, 130), (9, 33, 9)]


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "M{}_K{}_N{}".format(*s))
def test_model_matches_jax(shape, pair):
    """The model of the kernel against the JAX device program it replaces
    (where 128 * 127 * K < 2^31), with the setup's add rows."""
    M, K, N = shape
    rng = np.random.default_rng(3)
    b = u32(rng, (K, N))
    if pair:
        planes = [rng.integers(0, 128, (M, K)).astype(np.int8),
                  rng.integers(0, 4, (M, K)).astype(np.int8)]
        want = np.asarray(jax.jit(sj._dot_i8pair_u32)(*planes, b))
        c = -(464 // 2)
    else:
        planes = [rng.integers(-128, 128, (M, K)).astype(np.int8)]
        want = np.asarray(jax.jit(sj._dot_i8_u32)(planes[0], b))
        c = 128 - 464 // 2
    op = Operands(planes, b, rng)
    np.testing.assert_array_equal(model(op, None), want)
    add = add_row(b, c)
    want_c = (want.astype(np.uint64) + add[None, :]) & np.uint64(M32)
    np.testing.assert_array_equal(model(op, add), want_c)
    np.testing.assert_array_equal(want_c.astype(np.uint32), plain(planes, b, c))


@pytest.mark.parametrize("form", ["worst", "random"])
@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
@pytest.mark.parametrize("K", [65800, 92683])
def test_model_past_the_jax_bound(K, pair, form):
    """K beyond one s32 run (65,536 k) and beyond JAX's 128 * 127 * K < 2^31,
    at a few rows and columns, against the port's plain version: the worst
    values (a = -128, b = 0xFFFFFFFF; the pair form's a_lo = 127 with a_hi
    = 2 and 3 in its rows) keep every run inside int32 only because the
    accumulators restart."""
    M, N = 3, 12
    rng = np.random.default_rng(4)
    if form == "worst":
        b = np.full((K, N), M32, np.uint32)
        if pair:
            planes = [np.full((M, K), 127, np.int8),
                      np.array([[2], [3], [1]], np.int8).repeat(K, 1)]
        else:
            planes = [np.full((M, K), -128, np.int8)]
    else:
        b = u32(rng, (K, N))
        planes = [rng.integers(0, 128, (M, K)).astype(np.int8),
                  rng.integers(0, 4, (M, K)).astype(np.int8)] if pair \
            else [rng.integers(-128, 128, (M, K)).astype(np.int8)]
    c = -(464 // 2) if pair else 128 - 464 // 2
    op = Operands(planes, b, rng)
    np.testing.assert_array_equal(model(op, add_row(b, c)),
                                  plain(planes, b, c))
    if form == "worst" and not pair:
        # one run over the whole K would leave int32: -128 * 255 * K
        assert -128 * 255 * K < -2 ** 31


def stores(M: int, N: int) -> np.ndarray:
    """How often the kernel's fold_run stores each (m, n): per block (in the
    kernel's block order), warp, lane, m16 tile i, n8 tile u, row half h
    and column e."""
    count = np.zeros((M, N), np.int64)
    mt, nt = tiles(M, N)
    for bid in range(mt * nt):
        m0, n0 = block_tile(bid, M, N)
        for warp in range(WARPS):
            nw = warp_columns(warp)
            for i in range(MT):
                for u in range(NT):
                    for h in (0, 1):
                        for e in (0, 1):
                            m = m0 + 16 * i + G + 8 * h
                            n = n0 + nw + 8 * u + 2 * T + e
                            ok = (m < M) & (n < N)
                            np.add.at(count, (m[ok], n[ok]), 1)
    return count


@pytest.mark.parametrize("shape", [(131, 136), (257, 1024), (9, 9),
                                   (300, 40), (1024, 130), (2048, 1024),
                                   (65, 129), (64, 128), (1, 1000),
                                   (73, 1024), (201, 1000), (3, 12),
                                   (129, 257)],
                         ids=lambda s: "M{}_N{}".format(*s))
def test_tiled_stores_each_output_once(shape):
    """Ragged M and N included: (73, 1024) is the production H1's last 64
    rows and its 9-row band, at its width."""
    M, N = shape
    mt, nt = tiles(M, N)
    assert len({block_tile(bid, M, N) for bid in range(mt * nt)}) == mt * nt
    assert np.array_equal(stores(M, N), np.ones((M, N), np.int64))


def test_stages_fit_a_blocks_shared_memory():
    """The kernel's two stages of 128 k (the a planes' 64 rows, twice in
    the pair form, and b's 128 u32 columns) fit one block's shared memory
    on Hopper, with room for one block an SM."""
    for planes in (1, 2):
        smem = STAGES * (planes * BM * STAGE_K + STAGE_K * BN * 4)
        assert smem <= SMEM_PER_BLOCK


def test_tiled_rows_are_16_byte_aligned():
    """The tiled form copies 16-byte chunks: rows the wrapper hands it
    start on 16-byte boundaries, and their last chunk lies inside the
    storage (a copy in aligned rows where not)."""
    a = st.aligned_rows(5, 1003, "cpu")
    assert st._kernel_rows(a, st.ROW_ALIGN) is a
    b = torch.zeros((5, 1004), dtype=torch.int8)
    assert st._kernel_rows(b) is b                  # the select form's words
    c = st._kernel_rows(b, st.ROW_ALIGN)
    assert c is not b and c.stride(0) % 16 == 0 and torch.equal(c, b)
    d = st._kernel_rows(a[1:], st.ROW_ALIGN)
    assert d.data_ptr() % 16 == 0 and torch.equal(d, a[1:])


@pytest.mark.parametrize("pair", [False, True], ids=["one", "pair"])
def test_tiled_launch_refuses_cpu_tensors(pair):
    """The launch wrapper never falls back to the plain version: CPU
    tensors are refused before any launch; ``_dot`` takes the plain
    version only because they lie on the CPU."""
    rng = np.random.default_rng(6)
    M, K, N = 20, 100, 40
    lo = torch.from_numpy(rng.integers(0, 128, (M, K)).astype(np.int8))
    hi = torch.from_numpy(rng.integers(0, 4, (M, K)).astype(np.int8)) \
        if pair else None
    b = u32_bits(u32(rng, (K, N)), "cpu")
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        st._dot_launch(lo, hi, b, 5, False)
    got = st._dot(lo, hi, b, 5, False)
    assert _build.LAUNCHES == before
    assert torch.equal(got, st._dot_plain(lo, hi, b, 5, False))
