"""Kernel C's tiling (``ops.spiral.scan_tiling``) covers every output once.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py);
here the tiling that its wrapper hands it is held to the kernel's launch
limits and, through the kernel's own block / warp / lane arithmetic
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


def test_scan_tiling_refuses_unknown_forms():
    with pytest.raises(ValueError):
        sj.scan_tiling(32, 1024, 2048, 128, ntw=8)
    with pytest.raises(ValueError):
        sj.scan_tiling(32, 1024, 2048, 128, warps=16)


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
