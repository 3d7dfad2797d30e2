"""The yardstick of kernel I's roofline (csrc/scan_compact.cu): the least
time a dispatch's scan of the compact index needs, from the bucket's
parameters, the dispatch's query count and the rows the index holds (W: the
count of the program's ``engine.index`` record).

Counted as work.py counts kernel C's: each held row's residues (LIMBS bytes
each, over the CRT channels, the coefficients and the instance-trial
products) read once, the query columns (int32) read once and the products
(int32) written once, or LIMBS x LIMBS int8 products a residue pair, a
multiply and an add each, at the int8 peak. The count does not depend on
how the layout places the rows (slots, a bin's capacity): with W every row
it is ``work.scan_least_s``.
"""

from __future__ import annotations

from .work import INT8_OPS_PER_S, LIMBS, _sizes, least_time_s


def scan_compact_least_s(p: dict, nq: int, rows: int) -> float:
    """Kernel I over an index of ``rows`` rows for nq queries (2 * nq
    columns)."""
    s = _sizes(p)
    R = 2 * nq
    index_bytes = rows * s["crt"] * s["z"] * s["it"] * LIMBS
    cols_bytes = s["crt"] * s["z"] * s["dim0"] * R * 4
    out_bytes = s["crt"] * s["z"] * s["it"] * s["num_per"] * R * 4
    ops = 2 * index_bytes * LIMBS * R
    return least_time_s(index_bytes + cols_bytes + out_bytes, ops,
                        INT8_OPS_PER_S)
