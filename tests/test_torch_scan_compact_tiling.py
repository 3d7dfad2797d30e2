"""A CPU model of kernel I's tiling (csrc/scan_compact.cu) in numpy.

The kernel runs only on the card (tests/test_torch_kernels_gpu.py); here its
block, warp and lane arithmetic is replayed without it: every (row, column)
of a (channel, z) is stored exactly once, the staged DB words that each
lane's A fragments read are the words the plain version multiplies for that
bin, the copies and the fragment reads hit 32 distinct banks, and an
emulation of the m16n8k32 fragments (A words through the stage, B gathered
through idx_j, int32 sums by weight group, the Shoup epilogue) equals
``firstdim_multiply_compact_plain``. No JAX.
"""

import numpy as np
import pytest
import torch

from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.params import get_fast_expansion_testing_params

PARAMS = get_fast_expansion_testing_params()
THREADS, DB_WORDS = 256, 4096
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def stage_bins(sw: int) -> int:
    return 64 // sw


def stage_at(k, cw, i, b, sw: int):
    """Stage word of (limb k, step word cw, tile row i, bin b): the 16-byte
    chunks of a row permuted by its row bits."""
    bs = stage_bins(sw)
    lbs = bs.bit_length() - 1
    swz = (i >> (5 - lbs)) & (bs // 4 - 1)
    return ((k * sw + cw) * 16 + i) * bs + ((((b >> 2) ^ swz) << 2) | (b & 3))


def copies(vec: int, sw: int):
    """The DB-word copies of one stage as the kernel's threads issue them:
    copy id tid + 256 n -> tid, n, limb k, step word cw, tile row i and
    first bin b, each copy 4 bins wide (vec 1) or 1."""
    bs = stage_bins(sw)
    lbs = bs.bit_length() - 1
    per = 4 if vec else 16
    tid = np.repeat(np.arange(THREADS), per)
    n = np.tile(np.arange(per), THREADS)
    idx = tid + THREADS * n
    if vec:
        r, b = idx >> (lbs - 2), 4 * (idx & (bs // 4 - 1))
    else:
        r, b = idx >> lbs, idx & (bs - 1)
    return tid, n, r // (16 * sw), (r // 16) % sw, r % 16, b


def fragment_slots(bl: int, sw: int):
    """Stage words of the A registers (limb k, register e, lane) of the
    group's bin bl, -1 where the step word is past sw (read as zero)."""
    cw = [T, T, T + 4, T + 4]
    i = [G, G + 8, G, G + 8]
    return np.array([[np.where(cw[e] < sw, stage_at(k, np.minimum(cw[e],
                                                                 sw - 1),
                                                    i[e], bl, sw), -1)
                      for e in range(4)] for k in range(4)])


@pytest.mark.parametrize("sw", [2, 4, 8])
@pytest.mark.parametrize("vec", [0, 1])
def test_stage_copies_cover_the_stage_in_whole_sectors(vec, sw):
    bs = stage_bins(sw)
    tid, n, k, cw, i, b = copies(vec, sw)
    width = 4 if vec else 1
    at = stage_at(k, cw, i, b, sw)
    words = (at[:, None] + np.arange(width)).ravel()
    assert np.array_equal(np.sort(words), np.arange(DB_WORDS))
    # the copy of a chunk keeps its 4 bins in order
    assert np.array_equal(stage_at(k, cw, i, b + width - 1, sw),
                          at + width - 1)
    for n0 in np.unique(n):
        for w in range(8):
            sel = (n == n0) & (tid // 32 == w)
            # a warp's copy instruction reads whole 32-byte sectors: every
            # row it touches, all its bins (at 32 bins whole 128-byte lines)
            rows = k[sel] * 1000 + cw[sel] * 100 + i[sel]
            _, cnt = np.unique(rows, return_counts=True)
            assert np.all(cnt * width == bs)
            if vec:  # 16-byte writes: each quarter warp 8 distinct chunks
                for qw in range(4):
                    assert len(np.unique(at[sel][8 * qw:8 * qw + 8] // 4
                                         % 8)) == 8
            else:
                assert len(np.unique(at[sel] % 32)) == 32


@pytest.mark.parametrize("sw", [2, 4, 8])
def test_fragment_reads_of_a_bin(sw):
    """Each A register a warp reads is the (limb, step word, tile row) the
    fragment layout names, of its own bin, over 8 banks (at most 4-way)."""
    for bl in range(stage_bins(sw)):
        slots = fragment_slots(bl, sw)
        for k in range(4):
            for e in range(4):
                live = slots[k, e] >= 0
                assert live.any() == (e < 2 or sw == 8)
                if not live.any():
                    continue
                assert np.all(slots[k, e][live] % 4 == bl % 4)
                _, cnt = np.unique(slots[k, e][live] % 32, return_counts=True)
                assert cnt.max() <= 4


def stores(tl: sj.CompactScanTiling, R: int, it: int, npr: int) -> np.ndarray:
    """How often the epilogue stores each (row m, column) of one (channel,
    z): per block (bin block, column block), bin group, m16 tile, warp and
    its bins, lane, tile u and half h."""
    count = np.zeros((it * npr, R), dtype=np.int64)
    bs = stage_bins(tl.sw)
    nbg = -(-npr // bs)
    for cb in range(tl.ncb):
        col0 = cb * tl.rb
        rbw = min(tl.rb, R - col0)
        for bx in range(tl.nbb):
            for bgl in range(min(tl.gpb, nbg - bx * tl.gpb)):
                for mt in range(-(-it // 16)):
                    for warp in range(8):
                        for bl in range(warp, bs, 8):
                            b = (bx * tl.gpb + bgl) * bs + bl
                            if b >= npr:
                                break
                            for u in range(min(tl.ntw, -(-rbw // 8))):
                                col = u * 8 + 2 * T
                                for h in (0, 1):
                                    i = mt * 16 + G + 8 * h
                                    ok = (col < rbw) & (i < it)
                                    for e in (0, 1):
                                        np.add.at(count, (i[ok] * npr + b,
                                                          col0 + col[ok] + e),
                                                  1)
    return count


# (R, rows a bin, num_per, dim0, cap): the 1 GiB bucket's S2 read and
# 16-batch and its S1 read, the fast params, tails of rows, bins and
# columns, and the widest dim0
COVER = [(2, 16, 64, 512, 128), (32, 16, 64, 512, 128), (2, 16, 64, 512, 8),
         (2, 4, 4, 64, 16), (34, 24, 12, 64, 44), (6, 4, 20, 8, 8),
         (16, 40, 8, 17066, 64), (2, 16, 8, 24696, 128),
         (8, 16, 64, 5688, 256), (130, 3, 9, 5, 4)]


@pytest.mark.parametrize("shape", COVER,
                         ids=lambda s: "R{}_it{}_npr{}_d{}_cap{}".format(*s))
def test_compact_tiling_stores_each_output_once(shape):
    R, it, npr, dim0, cap = shape
    tl = sj.compact_scan_tiling(R, npr, dim0, cap)
    assert sj.compact_scan_smem(tl.rb, dim0, tl.ns, tl.sw) <= 232448
    assert tl.rb % 2 == 0 and 2 <= tl.rb <= 8 * tl.ntw and 2 <= tl.ns <= 4
    assert tl.vec == (npr % 4 == 0)
    assert tl.sw == (2 if cap <= 8 else 4 if cap <= 16 else 8)
    assert (tl.ncb - 1) * tl.rb < R
    assert (tl.nbb - 1) * tl.gpb * stage_bins(tl.sw) < npr
    assert np.array_equal(stores(tl, R, it, npr),
                          np.ones((it * npr, R), dtype=np.int64))
    for gpb in (1, 2):
        tg = sj.compact_scan_tiling(R, npr, dim0, cap, ntw=tl.ntw, rb=tl.rb,
                                    gpb=gpb)
        assert np.array_equal(stores(tg, R, it, npr),
                              np.ones((it * npr, R), dtype=np.int64))


def test_compact_tiling_accepts_what_the_dp4a_wrapper_did():
    """Every (R, dim0) that the former kernel's shared-memory rule took
    (4 dim0 (rb + 1) <= 200 KB with rb its narrowest column block) still
    has a tiling, and forms past the card's shared memory are refused."""
    for R in (2, 4, 6, 8, 32, 34):
        rt = 8 if R % 8 == 0 else 4 if R % 4 == 0 else 2
        widest = 200 * 1024 // (4 * (rt + 1))
        tl = sj.compact_scan_tiling(R, 64, widest, 128)
        assert sj.compact_scan_smem(tl.rb, widest, tl.ns, tl.sw) <= 232448
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(2, 64, 24697, 8)
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(2, 64, 512, 8, ns=5)
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(32, 9, 512, 8, vec=1)
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(32, 64, 512, 12, sw=2)
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(32, 64, 512, 8, ntw=8)
    with pytest.raises(ValueError):
        sj.compact_scan_tiling(32, 64, 512, 8, ntw=1, rb=16)


def limbs(v):
    return [(v >> (7 * l)) & 127 for l in range(4)]


def mma(a, b):
    """m16n8k32 s8 x s8 -> s32 on fragments: a (..., 4 regs, 32 lanes), b
    (..., 2, 32) uint32 -> the product's (..., 4, 32) accumulator words."""
    lead = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    ab, bb = (np.ascontiguousarray(np.broadcast_to(x, lead + x.shape[-2:]),
                                   dtype="<u4").view(np.int8)
              .reshape(lead + x.shape[-2:] + (4,)).astype(np.int64)
              for x in (a, b))
    A = np.zeros(lead + (16, 32), dtype=np.int64)
    B = np.zeros(lead + (32, 8), dtype=np.int64)
    for e, (dr, dc) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        for x in range(4):
            A[..., G + dr, dc + 4 * T + x] = ab[..., e, :, x]
    for h in (0, 1):
        for x in range(4):
            B[..., 16 * h + 4 * T + x, G] = bb[..., h, :, x]
    D = A @ B
    out = np.zeros(lead + (4, 32), dtype=np.int64)
    for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
        out[..., e, :] = D[..., G + dr, 2 * T + dc]
    return out


def shoup_recombine(acc, q: int):
    """sum_s acc[s] 2^{7s} mod q as the epilogue forms it: the 64-bit sum,
    then Shoup on its high word times 2^32 mod q and on its low word."""
    w = sj.epilogue_constants(q)
    m32 = np.uint64(0xFFFFFFFF)

    def mul_shoup(a, wv, wq):
        hi = (a * np.uint64(wq)) >> np.uint64(32)
        r = (a * np.uint64(wv) - hi * np.uint64(q)) & m32
        return np.where(r >= q, r - np.uint64(q), r)

    x = sum(acc[s].astype(np.uint64) * np.uint64(w[s]) for s in range(7))
    assert int(x.max()) < 1 << 62
    r = (mul_shoup(x >> np.uint64(32), w[7], w[8])
         + mul_shoup(x & m32, 1, w[9]))
    return np.where(r >= q, r - np.uint64(q), r)


def emulate(words, idx_j, query, moduli, tl: sj.CompactScanTiling):
    """Kernel I on numpy arrays: words (2, Z, 4, CW, M) int32, idx_j (npr,
    cap), query (2, Z, dim0, R) -> (2, Z, M, R), block by block."""
    _, Z, _, CW, M = words.shape
    npr, cap = idx_j.shape
    dim0, R = query.shape[2:]
    it = M // npr
    kb, dbw, sw = stage_bins(tl.sw), DB_WORDS, tl.sw
    nbg, MT, nks = -(-npr // kb), -(-it // 16), -(-CW // sw)
    ld = tl.rb + 1 if tl.rb >= 8 else tl.rb
    out = np.full((2, Z, M, R), -1, dtype=np.int64)
    junk = np.random.default_rng(0)      # what a stage held before
    # the stage as the copies lay it out, word by word
    _, _, ck, ccw, ci, cb0 = copies(tl.vec, sw)
    width = 4 if tl.vec else 1
    ck, ccw, ci = (np.repeat(x, width) for x in (ck, ccw, ci))
    cb_ = (cb0[:, None] + np.arange(width)).ravel()
    at = stage_at(ck, ccw, ci, cb_, sw)
    slots = np.stack([fragment_slots(bl, sw) for bl in range(kb)])
    for c in range(2):
        q = moduli[c]
        for z in range(Z):
            for cb in range(tl.ncb):
                col0 = cb * tl.rb
                rbw = min(tl.rb, R - col0)
                ntb = -(-rbw // 8)
                W = np.zeros((dim0, ld), dtype=np.uint32)
                cols = col0 + np.arange(tl.rb)
                v = np.where(cols < R, query[c, z][:, np.minimum(cols, R - 1)],
                             0).astype(np.int64)
                W[:, :tl.rb] = sum(l_ << (8 * l) for l, l_ in
                                   enumerate(limbs(v)))
                for bx in range(tl.nbb):
                    bg0 = bx * tl.gpb
                    S = min(tl.gpb, nbg - bg0) * MT * nks
                    acc = np.zeros((kb, 7, tl.ntw, 4, 32), dtype=np.int64)
                    for s in range(S):
                        ks, mt, bgl = s % nks, (s // nks) % MT, s // (nks * MT)
                        # the stage, as the copies fill it; words past CW, IT
                        # or num_per are not copied and keep what was there
                        bin_ = (bg0 + bgl) * kb + cb_
                        i = mt * 16 + ci
                        cw = ks * sw + ccw
                        ok = (bin_ < npr) & (i < it) & (cw < CW)
                        buf = junk.integers(0, 1 << 32, dbw + 32 * kb,
                                            dtype=np.uint32)
                        m = np.where(ok, i * npr + bin_, 0)
                        buf[at[ok]] = words[c, z, ck[ok], cw[ok], m[ok]].view(
                            np.uint32)
                        # idx_j of the step's 32 slots: word tid + 256 n
                        # is bin word // 32, slot 32 ks + word % 32
                        word = np.arange(32 * kb)
                        ib = (bg0 + bgl) * kb + word // 32
                        slot = ks * 32 + word % 32
                        iok = (ib < npr) & (slot < cap)
                        buf[dbw + word] = np.where(iok, idx_j[
                            np.minimum(ib, npr - 1),
                            np.minimum(slot, cap - 1)], 0)
                        bins = (bg0 + bgl) * kb + np.arange(kb)
                        live = bins < npr
                        a = np.where(slots >= 0, buf[np.maximum(slots, 0)],
                                     0).astype(np.uint32)  # (kb, 4, 4, 32)
                        # lane (g, t) reads the int4 at bin * 8 + t (h = 0)
                        # and 4 further (h = 1)
                        js = buf[dbw:].reshape(kb, 8, 4).astype(np.int64)
                        jr = np.stack([js[:, T + 4 * h] for h in (0, 1)],
                                      axis=1)             # (kb, 2, 32, 4)
                        for u in range(min(tl.ntw, ntb)):
                            col = (u * 8 + G)[None, None, :, None]
                            # zero past the block's columns and past cap
                            live_b = (col < tl.rb) & (
                                ks * 32 + 16 * np.arange(2)[None, :, None, None]
                                + 4 * T[None, None, :, None] < cap)
                            wv = np.where(live_b,
                                          W[jr, np.minimum(col, ld - 1)], 0)
                            # byte l of the four slots' words -> limb l
                            by = wv.astype("<u4").view(np.uint8).reshape(
                                wv.shape + (4,)).astype(np.uint32)
                            b = sum(by[..., x, :] << (8 * x) for x in range(4))
                            # b: (kb, 2, 32, limb) -> (kb, limb, 2, 32)
                            b = np.moveaxis(b, -1, 1)
                            prod = mma(a[:, :, None], b[:, None])
                            for k in range(4):
                                for l in range(4):
                                    acc[:, k + l, u] += prod[:, k, l]
                        assert np.abs(acc).max() < 1 << 31
                        if ks == nks - 1:
                            # fragment rows past IT hold sums of stale words
                            # and are not stored
                            row_e = (mt * 16 + G[None, :]
                                     + 8 * (np.arange(4)[:, None] // 2))
                            for w in np.nonzero(live)[0]:
                                res = shoup_recombine(
                                    np.where(row_e < it, acc[w], 0), q)
                                for u in range(min(tl.ntw, ntb)):
                                    colu = u * 8 + 2 * T
                                    for h in (0, 1):
                                        ii = mt * 16 + G + 8 * h
                                        sel = (colu < rbw) & (ii < it)
                                        for e in (0, 1):
                                            out[c, z, ii[sel] * npr + bins[w],
                                                col0 + colu[sel] + e] = res[
                                                u, 2 * h + e, sel]
                            acc[:] = 0
    return out


def compact_case(rng, inst, trials, npr, cap, dim0, R, z=1, full=False):
    if full:
        vals = np.full((2, z, inst, trials, npr, cap), (1 << 28) - 1)
        q_arr = np.full((2, z, dim0, R), (1 << 28) - 1)
    else:
        vals = np.stack([rng.integers(0, q, (z, inst, trials, npr, cap))
                         for q in PARAMS.moduli])
        vals[..., cap - 3:] = 0            # unoccupied slots
        q_arr = np.stack([rng.integers(0, q, (z, dim0, R))
                          for q in PARAMS.moduli])
    idx_j = np.stack([rng.choice(dim0, cap, replace=cap > dim0)
                      for _ in range(npr)])
    if not full:
        idx_j[:, cap - 3:] = 0
        idx_j[0, 0] = 0                    # an occupied slot at column 0
    planes = sj.db_limbs(PARAMS, torch.from_numpy(vals))
    db = sj.CompactDb(planes, torch.from_numpy(idx_j.astype(np.int32)))
    return db, torch.from_numpy(q_arr.astype(np.int32))


# (instances, trials, num_per, cap, dim0, R): rows a bin 4, 16, 24; caps 8,
# 12, 16, 128; R 2, 6, 8, 32, 34; partial bin groups (num_per 4, 12, 40)
EMULATED = [(1, 4, 4, 8, 64, 2), (4, 4, 8, 128, 256, 32),
            (6, 4, 12, 12, 40, 34), (1, 4, 4, 16, 64, 6),
            (6, 4, 4, 128, 200, 2), (4, 4, 12, 8, 32, 32),
            (1, 4, 40, 16, 64, 8)]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "it{}_npr{}_cap{}_R{}"
                         .format(c[0] * c[1], c[2], c[3], c[5]))
def test_fragment_emulation_matches_plain(case):
    inst, trials, npr, cap, dim0, R = case
    rng = np.random.default_rng(sum(case))
    db, q_arr = compact_case(rng, inst, trials, npr, cap, dim0, R)
    want = sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr)
    words = db.planes.numpy().view(np.int32).reshape(
        2, 1, 4, cap // 4, inst * trials * npr)
    tls = {sj.compact_scan_tiling(R, npr, dim0, cap),
           sj.compact_scan_tiling(R, npr, dim0, cap, ntw=1, rb=2, gpb=1, ns=2),
           sj.compact_scan_tiling(R, npr, dim0, cap, ntw=1, rb=2, vec=0),
           sj.compact_scan_tiling(R, npr, dim0, cap, sw=8)}
    for tl in tls:
        got = emulate(words, db.idx_j.numpy(), q_arr.numpy(),
                      PARAMS.moduli, tl)
        assert np.array_equal(got.reshape(want.shape), want.numpy()), tl


def test_fragment_emulation_widest_dim0_all_limbs_127():
    """The widest dim0 a block's shared memory takes (R = 2, rb = 2), every
    limb of both operands 127."""
    dim0 = 24696
    tl = sj.compact_scan_tiling(2, 8, dim0, 128)
    assert tl.rb == 2 and sj.compact_scan_smem(2, dim0, tl.ns) == 232448
    db, q_arr = compact_case(np.random.default_rng(9), 4, 4, 8, 128, dim0, 2,
                             full=True)
    assert int(db.planes.min()) == int(db.planes.max()) == 127
    want = sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr)
    words = db.planes.numpy().view(np.int32).reshape(2, 1, 4, 32, 128)
    got = emulate(words, db.idx_j.numpy(), q_arr.numpy(), PARAMS.moduli, tl)
    assert np.array_equal(got.reshape(want.shape), want.numpy())


def test_scan_compact_launch_refuses_cpu_tensors():
    """The launch wrapper never falls back to the plain version: a CPU
    tensor is refused, and only firstdim_multiply routes it there."""
    db, q_arr = compact_case(np.random.default_rng(5), 1, 4, 4, 8, 16, 2)
    with pytest.raises(ValueError, match="CUDA"):
        sj._scan_compact_launch(PARAMS, db, q_arr)
    assert torch.equal(sj.firstdim_multiply(PARAMS, db, q_arr),
                       sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr))
