"""DoublePIR database layout (reference lib/doublepir/src/database/database.rs).

The DB is an (l, m) u32 matrix of Z_p elements. Small entries pack several
per element (`packing`); large entries span `ne` base-p elements laid out on
consecutive rows, repeated in `x` independent scheme instances.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .params import Params, num_db_entries
from .matrix import (SQUISH_BASIS, SQUISH_DELTA, U32, U64, squish, unsquish)


def base_p(p: int, m: int, i: int) -> int:
    for _ in range(i):
        m //= p
    return m % p


def reconstruct_from_base_p(p: int, vals: list[int]) -> int:
    res, coeff = 0, 1
    for i, v in enumerate(vals):
        res += coeff * int(v)
        if i < len(vals) - 1:
            coeff *= p
    return res


@dataclass
class DbInfo:
    num_entries: int
    bits_per_entry: int
    packing: int        # entries per Z_p element (0 if entries span elements)
    ne: int             # Z_p elements per entry
    x: int              # scheme repetitions (divisor of ne)
    p: int
    logq: int
    squish_basis: int = SQUISH_BASIS
    squish_delta: int = 0   # 0 = unsquished
    orig_cols: int = 0

    @staticmethod
    def new(num_entries: int, bits_per_entry: int, params: Params) -> "DbInfo":
        assert 0 < bits_per_entry < 64
        db_elems, elems_per_entry, entries_per_elem = num_db_entries(
            num_entries, bits_per_entry, params.p)
        info = DbInfo(num_entries=num_entries, bits_per_entry=bits_per_entry,
                      packing=entries_per_elem, ne=elems_per_entry,
                      x=elems_per_entry, p=params.p, logq=params.logq)
        while info.ne % info.x != 0:
            info.x += 1
        assert db_elems <= params.l * params.m
        return info

    def to_string(self) -> str:
        return (f"{self.num_entries},{self.bits_per_entry},{self.packing},"
                f"{self.ne},{self.x},{self.p},{self.logq},"
                f"{self.squish_basis},{self.squish_delta},{self.orig_cols}")

    @staticmethod
    def from_string(s: str) -> "DbInfo":
        v = [int(x) for x in s.split(",")]
        return DbInfo(*v)


class Db:
    def __init__(self, info: DbInfo, data: np.ndarray):
        self.info = info
        self.data = data    # (rows, cols) uint32

    @staticmethod
    def random(num_entries: int, bits_per_entry: int, params: Params,
               rng: np.random.Generator) -> "Db":
        info = DbInfo.new(num_entries, bits_per_entry, params)
        data = rng.integers(0, params.p, (params.l, params.m),
                            dtype=np.uint64).astype(U32)
        db = Db(info, data)
        db.data = db.data - U32(params.p // 2)   # wrapping recenter
        return db

    @staticmethod
    def from_entries(num_entries: int, bits_per_entry: int, params: Params,
                     entries) -> "Db":
        """entries: iterable of ints, each < 2^bits_per_entry
        (reference load_data, database.rs:168-207)."""
        info = DbInfo.new(num_entries, bits_per_entry, params)
        data = np.zeros((params.l, params.m), dtype=U32)
        flat = data.reshape(-1)
        if info.packing > 0:
            at = 0
            cur = 0
            coeff = 1
            entries = list(entries)
            for i, elem in enumerate(entries):
                cur += int(elem) * coeff
                coeff *= 1 << bits_per_entry
                if (i + 1) % info.packing == 0 or i == len(entries) - 1:
                    flat[at] = cur & 0xFFFFFFFF
                    at += 1
                    cur, coeff = 0, 1
        else:
            for i, elem in enumerate(entries):
                for j in range(info.ne):
                    row = (i // params.m) * info.ne + j
                    col = i % params.m
                    data[row, col] = base_p(info.p, int(elem), j)
        db = Db(info, data)
        db.data = db.data - U32(params.p // 2)
        return db

    @staticmethod
    def from_packed_bits(num_entries: int, params: Params,
                         bit_bytes: np.ndarray) -> "Db":
        """1-bit entries from an LSB-first packed bitarray — the checklist
        bloom store's native layout. Streams the element build in bounded
        chunks instead of materializing a per-entry Python list, so the
        production-scale config (2^30+ bits; reference
        js/bridge/src/doublepir_lib.rs:118-129) fits in host memory.

        Bit-exact vs from_entries(num_entries, 1, params, bits)."""
        info = DbInfo.new(num_entries, 1, params)
        P = info.packing
        assert P > 0, "1-bit entries always pack"
        n_elems = (num_entries + P - 1) // P
        assert n_elems <= params.l * params.m
        data = np.zeros((params.l, params.m), dtype=U32)
        flat = data.reshape(-1)
        if P == 8:
            # one element per byte: the packed-byte value IS the element
            # (LSB-first 8-bit groups) — the production config's case (p=464)
            nbytes = (num_entries + 7) // 8
            flat[:n_elems] = bit_bytes[:nbytes]
        else:
            weights = np.uint32(1) << np.arange(P, dtype=np.uint32)
            chunk_elems = 1 << 21
            for start in range(0, n_elems, chunk_elems):
                cnt = min(chunk_elems, n_elems - start)
                bit_lo = start * P
                bit_hi = min(num_entries, (start + cnt) * P)
                byte_lo = bit_lo // 8
                byte_hi = (bit_hi + 7) // 8
                bits = np.unpackbits(bit_bytes[byte_lo:byte_hi],
                                     bitorder="little")
                off = bit_lo - byte_lo * 8
                seg = np.zeros(cnt * P, dtype=np.uint8)
                avail = min(cnt * P, len(bits) - off, bit_hi - bit_lo)
                seg[:avail] = bits[off : off + avail]
                flat[start : start + cnt] = (
                    seg.reshape(cnt, P).astype(np.uint32) * weights
                ).sum(axis=1, dtype=np.uint32)
        db = Db(info, data)
        db.data = db.data - U32(params.p // 2)
        return db

    def num_rows(self) -> int:
        return self.data.shape[0]

    def squish(self):
        self.info.squish_delta = SQUISH_DELTA
        self.info.orig_cols = self.data.shape[1]
        self.data = squish(self.data)
        assert self.info.p <= (1 << self.info.squish_basis)

    def unsquish(self):
        self.data = unsquish(self.data, self.info.orig_cols)
        self.info.squish_delta = 0

    @staticmethod
    def reconstruct_elem(vals: list[int], index: int, info: DbInfo) -> int:
        q = 1 << info.logq
        vals = [((int(v) + info.p // 2) % q) % info.p for v in vals]
        val = reconstruct_from_base_p(info.p, vals)
        if info.packing > 0:
            val = base_p(1 << info.bits_per_entry, val, index % info.packing)
        return val

    def get_elem(self, i: int) -> int:
        """Read entry i back out of the (possibly squished) DB
        (database.rs:306-348)."""
        info = self.info
        assert i < info.num_entries
        cols = self.data.shape[1]
        col = i % cols
        row = i // cols
        orig_col = 0
        if info.packing > 0:
            new_i = i // info.packing
            col = new_i % cols
            row = new_i // cols
        if info.squish_delta > 0 and info.orig_cols > 0:
            new_i = i // info.packing if info.packing > 0 else i
            col = new_i % info.orig_cols
            row = new_i // info.orig_cols
            orig_col = col
            col = col // info.squish_delta
        vals = []
        for j in range(info.ne):
            idx = row * info.ne + j
            val = int(self.data[idx, col])
            if info.squish_delta > 0 and info.orig_cols > 0:
                k = orig_col % info.squish_delta
                val = (val >> (k * info.squish_basis)) & ((1 << info.squish_basis) - 1)
                val = (val - info.p // 2) % (1 << 64)   # pre-undo the +p/2
            vals.append(val)
        return Db.reconstruct_elem(vals, i, info)
