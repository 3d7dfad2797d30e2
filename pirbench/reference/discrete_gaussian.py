# Frozen copy of sdk_tpu_torch/discrete_gaussian.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""Discrete Gaussian sampler over Z, CDF-table based, matching the reference
(lib/spiral-rs/src/discrete_gaussian.rs): width 6.4, support [-26, 26],
inverse-CDF sampling from u64 draws."""

from __future__ import annotations

import math

import numpy as np

from .arith import U64

NUM_WIDTHS = 4


class DiscreteGaussian:
    def __init__(self, noise_width: float):
        self.max_val = math.ceil(noise_width * NUM_WIDTHS)
        probs = []
        total = 0.0
        for i in range(-self.max_val, self.max_val + 1):
            p = math.exp(-math.pi * float(i) ** 2 / noise_width**2)
            probs.append(p)
            total += p
        cdf = []
        cum = 0.0
        for p in probs:
            cum += p / total
            v = round(cum * float(0xFFFFFFFFFFFFFFFF))
            cdf.append(min(v, 0xFFFFFFFFFFFFFFFF))
        self.cdf_table = np.array(cdf, dtype=U64)

    def sample_arr(self, modulus: int, rng, count: int) -> np.ndarray:
        """Draw `count` samples as values mod `modulus` (uint64), consuming one
        u64 from `rng` per sample (same consumption as the reference).

        Constant-time selection: the reference scans the FULL CDF table per
        draw, accumulating the index with `subtle`'s branch-free comparisons
        (discrete_gaussian.rs:78-139) so neither the branch pattern nor the
        memory access pattern depends on the secret draw. The same structure
        here: a full (count x table) comparison summed — no data-dependent
        branch or index anywhere in the sample path (a searchsorted binary
        search walks a draw-dependent path). Equivalent value: the count of
        table entries < draw IS the first index with cdf[idx] >= draw."""
        draws = rng.next_u64(count)
        idx = (self.cdf_table[None, :] < draws[:, None]).sum(
            axis=1, dtype=np.int64)
        vals = idx - self.max_val
        # np.where is a vectorized select (both arms evaluated) — branch-free
        vals = np.where(vals < 0, vals + modulus, vals)
        return vals.astype(U64)

    def sample_matrix(self, params, rows: int, cols: int, rng) -> np.ndarray:
        vals = self.sample_arr(params.modulus, rng, rows * cols * params.poly_len)
        return vals.reshape(rows, cols, params.poly_len)
