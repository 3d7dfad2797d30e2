"""DoublePIR parameters (reference lib/doublepir/src/params/params.rs).

LWE with n=1024, q=2^32; (sigma, p) chosen from a fixed store keyed by the
number of LWE samples (log m). Params serialize to the same CSV string
`n,sigma,l,m,logq,p` the reference uses on the wire.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

LOGQ = 32
SEC_PARAM = 1 << 10
COMP_RATIO = 64
MAX_SEARCH_P = 1 << 20

# (log n, log m, log q, sigma, log p_simple, p_simple, p_double) —
# reference params_store.rs:4-13
PARAMS_STORE = [
    (10, 13, 32, 6.4, 9, 991, 929),
    (10, 14, 32, 6.4, 9, 833, 781),
    (10, 15, 32, 6.4, 9, 701, 657),
    (10, 16, 32, 6.4, 9, 589, 552),
    (10, 17, 32, 6.4, 8, 495, 464),
    (10, 18, 32, 6.4, 8, 416, 390),
    (10, 19, 32, 6.4, 8, 350, 328),
    (10, 20, 32, 6.4, 8, 294, 276),
    (10, 21, 32, 6.4, 7, 247, 231),
]


@dataclass
class Params:
    n: int      # LWE secret dimension
    sigma: float
    l: int      # DB height
    m: int      # DB width
    logq: int = LOGQ
    p: int = 0  # plaintext modulus

    def ext_delta(self) -> int:
        return (1 << self.logq) // self.p

    def delta(self) -> int:
        return math.ceil(self.logq / math.log2(self.p))

    def round(self, x: int) -> int:
        ed = self.ext_delta()
        return ((int(x) + ed // 2) // ed) % self.p

    def round_vec(self, x: np.ndarray) -> np.ndarray:
        """Vectorized round over uint32/uint64 arrays."""
        ed = np.uint64(self.ext_delta())
        v = (x.astype(np.uint64) + ed // np.uint64(2)) // ed
        return (v % np.uint64(self.p)).astype(np.uint32)

    def to_string(self) -> str:
        sigma = self.sigma
        s = str(int(sigma)) if sigma == int(sigma) else str(sigma)
        return f"{self.n},{s},{self.l},{self.m},{self.logq},{self.p}"

    @staticmethod
    def from_string(s: str) -> "Params":
        n, sigma, l, m, logq, p = s.split(",")
        return Params(int(n), float(sigma), int(l), int(m), int(logq), int(p))

    @staticmethod
    def pick(n: int, logq: int, l: int, m: int, max_samples: int) -> "Params":
        for (logn, logm, logq_s, sigma, _, _, p_double) in PARAMS_STORE:
            if n == (1 << logn) and max_samples <= (1 << logm) and logq == logq_s:
                p = p_double
                if p == 552:  # reference rounding hack (params.rs:96-99)
                    p = 512
                return Params(n, sigma, l, m, logq, p)
        raise ValueError("No suitable params known")


def compute_num_entries_base_p(p: int, logq: int) -> int:
    return math.ceil(logq / math.log2(p))


def num_db_entries(num_entries: int, bits_per_entry: int, p: int):
    """-> (db_elems, elems_per_entry(ne), entries_per_elem(packing))
    (reference database.rs:352-371)."""
    if bits_per_entry <= math.log2(p):
        logp = int(math.log2(p))
        entries_per_elem = logp // bits_per_entry
        db_entries = math.ceil(num_entries / entries_per_elem)
        assert 0 < db_entries <= num_entries
        return db_entries, 1, entries_per_elem
    ne = compute_num_entries_base_p(p, bits_per_entry)
    return num_entries * ne, ne, 0


def approx_square_database_dims(num_entries: int, bits_per_entry: int, p: int):
    db_elems, elems_per_entry, _ = num_db_entries(num_entries, bits_per_entry, p)
    l = int(math.floor(math.sqrt(db_elems)))
    rem = l % elems_per_entry
    if rem != 0:
        l += elems_per_entry - rem
    m = math.ceil(db_elems / l)
    return l, m


def approx_database_dims(num_entries: int, bits_per_entry: int, p: int,
                         lower_bound_m: int):
    l, m = approx_square_database_dims(num_entries, bits_per_entry, p)
    if m >= lower_bound_m:
        return l, m
    m = lower_bound_m
    db_elems, elems_per_entry, _ = num_db_entries(num_entries, bits_per_entry, p)
    l = math.ceil(db_elems / m)
    rem = l % elems_per_entry
    if rem != 0:
        l += elems_per_entry - rem
    return l, m


def pick_params(num_entries: int, d: int, n: int = SEC_PARAM,
                logq: int = LOGQ, lower_bound_m: int | None = None) -> Params:
    """Iteratively refine p against the store (reference doublepir.rs:17-43).
    lower_bound_m defaults to COMP_RATIO*n (production); tests pass 1 for
    small square DBs."""
    if lower_bound_m is None:
        lower_bound_m = COMP_RATIO * n
    good = None
    mod_p = 2
    while mod_p < MAX_SEARCH_P:
        l, m = approx_database_dims(num_entries, d, mod_p, lower_bound_m)
        p = Params.pick(n, logq, l, m, max(l, m))
        if p.p < mod_p:
            assert good is not None
            return good
        good = p
        mod_p += 1
    raise ValueError("could not find params")
