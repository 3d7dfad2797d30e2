"""Spiral scheme parameters. JSON schema identical to the reference
(lib/spiral-rs/src/params.rs, util.rs:219-263)."""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from .arith import (
    div2_uint_mod,
    exponentiate_uint_mod,
    invert_uint_mod,
    log2_ceil,
    log2_exact,
    multiply_uint_mod,
    reverse_bits,
)

SEED_LENGTH = 32
HAMMING_WEIGHT = 256
MIN_Q2_BITS = 14

DEFAULT_MODULI = (268369921, 249561089)

# Reference params.rs:8-46
Q2_VALUES = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    12289, 12289, 61441, 65537, 65537, 520193, 786433, 786433, 3604481,
    7340033, 16515073, 33292289, 67043329, 132120577, 268369921, 469762049,
    1073479681, 2013265921, 4293918721, 8588886017, 17175674881, 34359214081,
    68718428161,
]


def is_primitive_root(root: int, degree: int, modulus: int) -> bool:
    if root == 0:
        return False
    return exponentiate_uint_mod(root, degree >> 1, modulus) == modulus - 1


def get_minimal_primitive_root(degree: int, modulus: int) -> int:
    """Deterministic minimal primitive `degree`-th root of unity mod `modulus`.

    The reference (number_theory.rs:41-55) finds a random primitive root then
    minimizes over all odd powers; the minimum over that orbit is the unique
    minimal primitive root, so a deterministic search gives the same value.
    """
    group = modulus - 1
    quotient = group // degree
    assert group % degree == 0
    root = None
    for cand in range(2, 10000):
        r = exponentiate_uint_mod(cand, quotient, modulus)
        if is_primitive_root(r, degree, modulus):
            root = r
            break
    assert root is not None
    gen_sq = multiply_uint_mod(root, root, modulus)
    cur = root
    best = root
    for _ in range(degree):
        if cur < best:
            best = cur
        cur = multiply_uint_mod(cur, gen_sq, modulus)
    return best


def build_ntt_tables(poly_len: int, moduli: tuple[int, ...]) -> list[list[np.ndarray]]:
    """Shoup NTT tables, identical to reference ntt.rs:39-65.

    For each modulus: [root_powers, scaled_root_powers, inv_root_powers,
    scaled_inv_root_powers], each a uint64 array of length poly_len, indexed
    in bit-reversed order (table[m+i] drives butterfly group i of stage m).
    """
    poly_len_log2 = log2_exact(poly_len)
    out = []
    for modulus in moduli:
        root = get_minimal_primitive_root(2 * poly_len, modulus)
        inv_root = invert_uint_mod(root, modulus)

        def powers_of(r: int) -> np.ndarray:
            tbl = np.zeros(poly_len, dtype=np.uint64)
            power = r
            for i in range(1, poly_len):
                idx = reverse_bits(i, poly_len_log2)
                tbl[idx] = power
                power = multiply_uint_mod(power, r, modulus)
            tbl[0] = 1
            return tbl

        root_powers = powers_of(root)
        inv_root_powers = powers_of(inv_root)
        for i in range(poly_len):
            inv_root_powers[i] = div2_uint_mod(int(inv_root_powers[i]), modulus)

        def scale_u32(tbl: np.ndarray) -> np.ndarray:
            # floor(w * 2^32 / q), truncated to u32 (ntt.rs:29-37)
            scaled = (tbl.astype(object) << 32) // modulus
            return np.array([int(x) & 0xFFFFFFFF for x in scaled], dtype=np.uint64)

        out.append(
            [root_powers, scale_u32(root_powers), inv_root_powers, scale_u32(inv_root_powers)]
        )
    return out


@dataclass
class Params:
    """All Spiral scheme parameters and derived values (params.rs:48-297)."""

    poly_len: int = 2048
    moduli: tuple[int, ...] = DEFAULT_MODULI
    noise_width: float = 6.4
    n: int = 2
    pt_modulus: int = 256
    q2_bits: int = 20
    t_conv: int = 4
    t_exp_left: int = 8
    t_exp_right: int = 56
    t_gsw: int = 8
    expand_queries: bool = True
    db_dim_1: int = 9
    db_dim_2: int = 6
    instances: int = 1
    db_item_size: int = 8192
    version: int = 0

    def __post_init__(self):
        assert self.q2_bits >= MIN_Q2_BITS
        self.poly_len_log2 = log2_exact(self.poly_len)
        self.crt_count = len(self.moduli)
        self.modulus = 1
        for m in self.moduli:
            self.modulus *= m
        self.modulus_log2 = log2_ceil(self.modulus)
        if self.crt_count == 2:
            q0, q1 = self.moduli
            self.mod0_inv_mod1 = q0 * invert_uint_mod(q0, q1)
            self.mod1_inv_mod0 = q1 * invert_uint_mod(q1, q0)
            # Garner constant for the compose path: inv(q0) mod q1
            self.inv_q0_mod_q1 = invert_uint_mod(q0, q1)

    @cached_property
    def ntt_tables(self) -> list[list[np.ndarray]]:
        return build_ntt_tables(self.poly_len, self.moduli)

    # --- derived dimensions ---

    def num_expanded(self) -> int:
        return 1 << self.db_dim_1

    def num_items(self) -> int:
        return (1 << self.db_dim_1) * (1 << self.db_dim_2)

    def item_size(self) -> int:
        logp = log2_exact(self.pt_modulus)
        return self.instances * self.n * self.n * self.poly_len * logp // 8

    def g(self) -> int:
        num_bits_to_gen = self.t_gsw * self.db_dim_2 + self.num_expanded()
        return log2_ceil(num_bits_to_gen)

    def stop_round(self) -> int:
        return log2_ceil(self.t_gsw * self.db_dim_2)

    def factor_on_first_dim(self) -> int:
        return 1 if self.db_dim_2 == 0 else 2

    def setup_bytes(self) -> int:
        sz_polys = 0
        num_packing_mats = self.n if self.version == 0 else 2
        packing_sz = self.n * self.t_conv
        sz_polys += num_packing_mats * packing_sz
        if self.expand_queries:
            expansion_left_sz = self.g() * self.t_exp_left
            expansion_right_sz = (self.stop_round() + 1) * self.t_exp_right
            conversion_sz = 2 * self.t_conv
            if self.version > 0 and self.t_exp_left == self.t_exp_right:
                expansion_right_sz = 0
            sz_polys += expansion_left_sz + expansion_right_sz + conversion_sz
        return SEED_LENGTH + sz_polys * self.poly_len * 8

    def query_bytes(self) -> int:
        if self.expand_queries:
            sz_polys = 1
        else:
            sz_polys = self.num_expanded() + self.db_dim_2 * (2 * self.t_gsw)
        return SEED_LENGTH + sz_polys * self.poly_len * 8

    def query_v_buf_bytes(self) -> int:
        return self.num_expanded() * self.poly_len * 8

    def bytes_per_chunk(self) -> int:
        chunks = self.instances * self.n * self.n
        return math.ceil(self.db_item_size / chunks)

    def modp_words_per_chunk(self) -> int:
        logp = log2_exact(self.pt_modulus)
        return math.ceil(self.bytes_per_chunk() * 8 / logp)

    # --- CRT ---

    def crt_compose_2(self, x: int, y: int) -> int:
        # Garner: unique v in [0, q0*q1) with v = x mod q0, v = y mod q1.
        q0, q1 = self.moduli
        t = ((y - x) * self.inv_q0_mod_q1) % q1
        return x + q0 * t

    def crt_compose_arr(self, residues: np.ndarray) -> np.ndarray:
        """residues: (..., crt_count, poly_len) uint64 → (..., poly_len) uint64."""
        if self.crt_count == 1:
            return residues[..., 0, :]
        q0, q1 = self.moduli
        x = residues[..., 0, :]
        y = residues[..., 1, :]
        t = ((y + np.uint64(q1) - x % np.uint64(q1)) * np.uint64(self.inv_q0_mod_q1)) % np.uint64(q1)
        return x + np.uint64(q0) * t

    def get_v_neg1_raw(self) -> list[np.ndarray]:
        """-x^(2048 - 2^i) polynomials used by coefficient expansion
        (params.rs:98-107), in raw form (poly_len uint64)."""
        out = []
        for i in range(self.poly_len_log2):
            idx = self.poly_len - (1 << i)
            p = np.zeros(self.poly_len, dtype=np.uint64)
            p[idx] = self.modulus - 1  # negated unit coeff
            out.append(p)
        return out

    def clone_with_moduli(self, moduli: tuple[int, ...]) -> "Params":
        return Params(
            poly_len=self.poly_len, moduli=tuple(moduli),
            noise_width=self.noise_width, n=self.n, pt_modulus=self.pt_modulus,
            q2_bits=self.q2_bits, t_conv=self.t_conv,
            t_exp_left=self.t_exp_left, t_exp_right=self.t_exp_right,
            t_gsw=self.t_gsw, expand_queries=self.expand_queries,
            db_dim_1=self.db_dim_1, db_dim_2=self.db_dim_2,
            instances=self.instances, db_item_size=self.db_item_size,
            version=self.version,
        )


def params_from_json_obj(v: dict) -> Params:
    """Reference util.rs:224-263; identical JSON schema."""
    n = int(v["n"])
    db_dim_1 = int(v["nu_1"])
    db_dim_2 = int(v["nu_2"])
    instances = int(v.get("instances", 1))
    p = int(v["p"])
    q2_bits = max(int(v["q2_bits"]), MIN_Q2_BITS)
    t_gsw = int(v["t_gsw"])
    t_conv = int(v["t_conv"])
    t_exp_left = int(v["t_exp_left"])
    t_exp_right = int(v["t_exp_right"])
    do_expansion = "direct_upload" not in v

    db_item_size = int(v.get("db_item_size", 0))
    if db_item_size == 0:
        db_item_size = instances * n * n * 2048 * log2_ceil(p) // 8

    version = int(v.get("version", 0))

    return Params(
        poly_len=2048, moduli=DEFAULT_MODULI, noise_width=6.4, n=n,
        pt_modulus=p, q2_bits=q2_bits, t_conv=t_conv, t_exp_left=t_exp_left,
        t_exp_right=t_exp_right, t_gsw=t_gsw, expand_queries=do_expansion,
        db_dim_1=db_dim_1, db_dim_2=db_dim_2, instances=instances,
        db_item_size=db_item_size, version=version,
    )


def params_from_json(cfg: str) -> Params:
    return params_from_json_obj(json.loads(cfg))


def params_to_json_obj(p: Params) -> dict:
    out = {
        "n": p.n, "nu_1": p.db_dim_1, "nu_2": p.db_dim_2, "p": p.pt_modulus,
        "q2_bits": p.q2_bits, "t_gsw": p.t_gsw, "t_conv": p.t_conv,
        "t_exp_left": p.t_exp_left, "t_exp_right": p.t_exp_right,
        "instances": p.instances, "db_item_size": p.db_item_size,
        "version": p.version,
    }
    if not p.expand_queries:
        out["direct_upload"] = 1
    return out


# --- common test / demo configurations (reference util.rs:63-153) ---

def get_test_params() -> Params:
    return Params(2048, DEFAULT_MODULI, 6.4, 2, 256, 20, 4, 8, 56, 8, True, 9, 6, 1, 2048, 0)


def get_short_keygen_params() -> Params:
    return Params(2048, DEFAULT_MODULI, 6.4, 2, 256, 20, 4, 4, 4, 4, True, 9, 6, 1, 2048, 0)


def get_fast_expansion_testing_params() -> Params:
    return params_from_json(
        '{"n": 2, "nu_1": 6, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,'
        ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
        ' "db_item_size": 8192}'
    )


def get_no_expansion_testing_params() -> Params:
    return params_from_json(
        '{"direct_upload": 1, "n": 5, "nu_1": 6, "nu_2": 3, "p": 65536,'
        ' "q2_bits": 27, "t_gsw": 3, "t_conv": 56, "t_exp_left": 56,'
        ' "t_exp_right": 56}'
    )
