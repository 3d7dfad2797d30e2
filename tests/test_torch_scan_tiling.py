"""Kernel C's tiling (``ops.spiral.scan_tiling``) covers every output once.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py);
here the tiling that its wrapper hands it, in either form (``scan_kernel``
or ``scan_resident_kernel``), is held to the kernel's launch limits and,
through the kernel's own block / warp / lane arithmetic
(csrc/scan.cu), to writing each (row, column) of a (channel, z) exactly
once, and a CPU tensor is refused by the launch wrapper (no fallback).
"""

import numpy as np
import pytest
import torch

from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.params import get_fast_expansion_testing_params

# (R, M, Z, JW): the 1 GiB bucket's single read and 16-query batch (whole
# index and a 64 z-slice), a shard of the (dp=2, db=4) mesh, and the tails
SHAPES = [(2, 1024, 2048, 128), (32, 1024, 2048, 128), (32, 1024, 64, 128),
          (32, 512, 2048, 32), (2, 8, 8, 1), (34, 24, 4, 3), (6, 88, 3, 8192),
          (64, 1024, 2048, 128), (16, 1024, 2048, 128), (130, 40, 2, 5)]


def stores(tl: sj.ScanTiling, R: int, M: int) -> np.ndarray:
    """How often the kernel's epilogue stores each (row, column) of one
    (channel, z): per block (bx, column block), warp and lane, the rows
    m16 tile * 16 + g (+ 8) and columns of tile * 8 + 2t (+ 1)."""
    count = np.zeros((M, R), dtype=np.int64)
    ntp = tl.cgb * tl.ntw
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for cb in range(tl.ncb):
        col0 = cb * ntp * 8
        for bx in range(tl.bx):
            for warp in range(tl.wm * tl.cgb):
                wm, u0 = warp % tl.wm, (warp // tl.wm) * tl.ntw
                for i in range(tl.mtw):
                    m = ((bx * tl.mtw + i) * tl.wm + wm) * 16 + g
                    for u in range(tl.ntw):
                        col = col0 + (u0 + u) * 8 + 2 * t
                        for h in (0, 1):
                            row = m + 8 * h
                            ok = (col < R) & (row < M)
                            for e in (0, 1):
                                np.add.at(count, (row[ok], col[ok] + e), 1)
    return count


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "R{}_M{}_Z{}_JW{}"
                         .format(*s))
def test_scan_tiling_covers_each_output_once(shape):
    R, M, Z, JW = shape
    tl = sj.scan_tiling(R, M, Z, JW)
    assert 32 * tl.wm * tl.cgb <= 256
    assert tl.kc % 2 == 0 and tl.kc >= 2
    assert tl.kc * tl.cgb * tl.ntw * 1024 <= 128 * 1024
    # no block without work
    assert (tl.ncb - 1) * tl.cgb * tl.ntw * 8 < R
    assert (tl.bx - 1) * tl.wm * tl.mtw * 16 < M
    assert np.array_equal(stores(tl, R, M), np.ones((M, R), dtype=np.int64))


@pytest.mark.parametrize("ntw,warps,mtw", [(1, 4, 1), (2, 8, 3), (4, 2, 16),
                                           (4, 8, 2)])
def test_scan_tiling_overrides_cover(ntw, warps, mtw):
    R, M = 34, 72
    tl = sj.scan_tiling(R, M, 4, 27, ntw=ntw, warps=warps, mtw=mtw)
    assert tl.ntw == ntw
    assert np.array_equal(stores(tl, R, M), np.ones((M, R), dtype=np.int64))


# (R, M, Z, JW) whose query limbs today's form cannot hold in one fill (R >
# 64 at the 1 GiB bucket's JW = 128), and a ragged shape
RESIDENT_SHAPES = [(96, 1024, 2048, 128), (128, 1024, 2048, 128),
                   (256, 1024, 2048, 128), (136, 72, 4, 27)]


def resident_stores(tl: sj.ResidentScanTiling, R: int, M: int) -> np.ndarray:
    """How often scan_resident_kernel's epilogue stores each (row, column)
    of one (channel, z): per block x = bx index * ncb + column block, warp
    (wm, column group) and lane, the m16 tiles that hold rows (``mine``),
    rows tile * 16 + g (+ 8) and columns of tile * 8 + 2t (+ 1)."""
    count = np.zeros((M, R), dtype=np.int64)
    ntp = tl.cgb * 4
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    mt = -(-M // 16)
    for x in range(tl.ncb * tl.bx):
        cb, bxi = x % tl.ncb, x // tl.ncb
        col0 = cb * ntp * 8
        for warp in range(tl.wm * tl.cgb):
            wm, u0 = warp % tl.wm, (warp // tl.wm) * 4
            mine = (mt - wm + tl.wm - 1) // tl.wm - bxi * tl.mtw
            mine = max(0, min(tl.mtw, mine)) if col0 + u0 * 8 < R else 0
            row0 = (bxi * tl.mtw * tl.wm + wm) * 16 + g
            for i in range(mine):
                m = row0 + i * tl.wm * 16
                for u in range(4):
                    col = col0 + (u0 + u) * 8 + 2 * t
                    for h in (0, 1):
                        row = m + 8 * h
                        ok = (col < R) & (row < M)
                        for e in (0, 1):
                            np.add.at(count, (row[ok], col[ok] + e), 1)
    return count


@pytest.mark.parametrize("shape", RESIDENT_SHAPES,
                         ids=lambda s: "R{}_M{}_Z{}_JW{}".format(*s))
def test_resident_tiling_covers_each_output_once(shape):
    R, M, Z, JW = shape
    tl = sj.resident_scan_tiling(R, M, Z, JW)
    assert 32 * tl.wm * tl.cgb <= 256
    # the query limbs of all of JW in one block and the channel's 10
    # epilogue constants: at most 227 KB
    assert -(-JW // 16) * 2 * tl.cgb * 4 * 1024 + 40 <= 227 * 1024
    # no block without work
    assert (tl.ncb - 1) * tl.cgb * 32 < R
    assert (tl.bx - 1) * tl.wm * tl.mtw * 16 < M
    assert np.array_equal(resident_stores(tl, R, M),
                          np.ones((M, R), dtype=np.int64))


@pytest.mark.parametrize("cgb,wm", [(1, 1), (1, 4), (1, 8), (2, 2), (2, 4)])
def test_resident_tiling_forms_cover(cgb, wm):
    R, M = 136, 72
    tl = sj.resident_scan_tiling(R, M, 4, 27, cgb=cgb, wm=wm)
    assert (tl.cgb, tl.wm) == (cgb, wm)
    assert np.array_equal(resident_stores(tl, R, M),
                          np.ones((M, R), dtype=np.int64))


def test_scan_tiling_picks_the_resident_form_above_one_fill():
    """At the 1 GiB bucket (M = 1024, Z = 2048, JW = 128) R = 2, 32 and 64
    keep today's tiling as it was; R = 96, 128 and 256, whose query limbs
    today's form would pack again for every m16 tile, take the resident
    form: 64-column blocks where the tiles fill them, else 32-column ones.
    Where no block can hold the query limbs of all of JW (dim0 = 2^15),
    and where a form is asked for, today's form stays."""
    assert sj.scan_tiling(32, 1024, 2048, 128) == sj.ScanTiling(
        ntw=4, ncb=1, cgb=1, wm=4, mtw=16, bx=1, kc=16)
    assert sj.scan_tiling(64, 1024, 2048, 128) == sj.ScanTiling(
        ntw=4, ncb=1, cgb=2, wm=2, mtw=32, bx=1, kc=16)
    for shape in SHAPES:
        if shape[0] <= 64:
            assert isinstance(sj.scan_tiling(*shape), sj.ScanTiling), shape
    for R, ncb, cgb in ((96, 3, 1), (128, 2, 2), (256, 4, 2)):
        assert sj.scan_tiling(R, 1024, 2048, 128) == sj.ResidentScanTiling(
            ncb=ncb, cgb=cgb, wm=4, mtw=16, bx=1)
    assert sj.resident_scan_tiling(128, 16, 2, 1 << 13) is None
    assert isinstance(sj.scan_tiling(128, 16, 2, 1 << 13), sj.ScanTiling)
    assert isinstance(sj.scan_tiling(128, 1024, 2048, 128, ntw=4),
                      sj.ScanTiling)


def test_scan_tiling_refuses_unknown_forms():
    with pytest.raises(ValueError):
        sj.scan_tiling(32, 1024, 2048, 128, ntw=8)
    with pytest.raises(ValueError):
        sj.scan_tiling(32, 1024, 2048, 128, warps=16)
    with pytest.raises(ValueError):
        sj.resident_scan_tiling(128, 1024, 2048, 128, cgb=4)
    with pytest.raises(ValueError):
        sj.resident_scan_tiling(128, 1024, 2048, 128, cgb=2, wm=8)


def test_scan_launch_refuses_cpu_tensors():
    """The launch wrapper never falls back to the plain version: a CPU
    tensor is refused, and only firstdim_multiply routes it to the plain
    version."""
    params = get_fast_expansion_testing_params()
    rng = np.random.default_rng(5)
    vals = np.stack([rng.integers(0, q, (2, 1, 1, 16, 8))
                     for q in params.moduli])
    db = sj.db_limbs(params, torch.from_numpy(vals))
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (2, 8, 2)) for q in params.moduli]
    ).astype(np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sj._scan_launch(params, db, q_arr)
    assert torch.equal(sj.firstdim_multiply(params, db, q_arr),
                       sj.firstdim_multiply_plain(params, db, q_arr))
