"""The yardstick of the kernels' rooflines: the card's peaks and the work a
dispatch's inputs need in the scan (kernel C) and in the fold rounds
(kernel F), from the bucket's parameters and the dispatch's query count.

The counts are those of PERF.md's kernel table (chip_smoke.py's ``bound``
and the C and F rows at commit 1023d4a): each input byte read once, each
output byte written once, and the operations at the peak rate of their
type; the least time is the larger of the two. They count the work of the
queries a dispatch carries, not of the columns a kernel pads them to.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12         # int8 tensor cores
INT32_OPS_PER_S = 67e12          # 32/64-bit integer on the CUDA cores
BUTTERFLY_OPS = 6                # integer operations of one Harvey butterfly
LIMBS = 4                        # 7-bit int8 limbs of a residue below 2^28


def least_time_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def _sizes(p: dict) -> dict:
    """Sizes from a params JSON object (the schema of params_from_json)."""
    n = int(p["n"])
    return {"crt": 2, "z": 2048, "log_z": 11, "dim0": 1 << int(p["nu_1"]),
            "num_per": 1 << int(p["nu_2"]), "nu_2": int(p["nu_2"]),
            "it": int(p.get("instances", 1)) * n * n,
            "ell": 2 * int(p["t_gsw"])}


def scan_least_s(p: dict, nq: int) -> float:
    """Kernel C over the dense index for nq queries (2 * nq columns): the
    index (a 28-bit residue in LIMBS bytes), the query columns (int32) and
    the products (int32) once, or LIMBS x LIMBS int8 products a residue
    pair, a multiply and an add each, at the int8 peak."""
    s = _sizes(p)
    R = 2 * nq
    rows = s["crt"] * s["z"] * s["it"] * s["num_per"]
    index_bytes = rows * s["dim0"] * LIMBS
    cols_bytes = s["crt"] * s["z"] * s["dim0"] * R * 4
    out_bytes = rows * R * 4
    ops = 2 * index_bytes * LIMBS * R
    return least_time_s(index_bytes + cols_bytes + out_bytes, ops,
                        INT8_OPS_PER_S)


def transform_ops(n_two_channel: int, s: dict) -> int:
    """Integer operations of n two-channel negacyclic transforms."""
    return n_two_channel * 2 * (s["z"] // 2) * s["log_z"] * BUTTERFLY_OPS


def fold_round_least_s(p: dict, nq: int, r: int) -> float:
    """Round r of the fold (in_slots = num_per >> r slots a query and
    instance-trial, each output slot from two): per output slot 2 * ell
    forward and 2 inverse two-channel transforms and the 2 * ell digit
    polynomials' products with two key rows over two channels; the raw
    int64 slots in and out and the round's two key sets (int32) once."""
    s = _sizes(p)
    in_slots = s["num_per"] >> r
    slots_out = nq * s["it"] * in_slots // 2
    ops = slots_out * (transform_ops(2 * s["ell"] + 2, s)
                       + 2 * 2 * s["ell"] * 4 * s["z"])
    ct_bytes = nq * s["it"] * in_slots * 2 * s["z"] * 8
    key_bytes = nq * 2 * 2 * s["ell"] * 2 * s["z"] * 4
    return least_time_s(ct_bytes + ct_bytes // 2 + key_bytes, ops,
                        INT32_OPS_PER_S)


def fold_least_s(p: dict, nq: int) -> float:
    """Every round of one dispatch's fold."""
    return sum(fold_round_least_s(p, nq, r)
               for r in range(_sizes(p)["nu_2"]))
