# Frozen copy of sdk_tpu_torch/client.py at commit 1023d4a, part of the
# benchmark's yardstick: the numpy client that makes the queries and judges
# the answers. Later changes to the program do not change it.
"""Spiral client: secret keys, public parameters, query generation, response
decoding, and seed-compressed (de)serialization.

Byte formats are identical to the reference (lib/spiral-rs/src/client.rs):
every serialized matrix omits its pseudorandom first row, which both sides
regenerate from a 32-byte ChaCha20 seed as Q - (u64 % Q)
(client.rs:47-49, 68-93). The RNG draw order below deliberately mirrors the
reference's deserializers so seeds reproduce the same pseudorandom rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import poly
from .poly import build_gadget
from .arith import U64, invert_uint_mod, log2_ceil, recenter
from .bitpack import read_fields
from .discrete_gaussian import DiscreteGaussian
from .ntt_host import ntt_forward
from .params import Params, Q2_VALUES, SEED_LENGTH, HAMMING_WEIGHT
from .rng import ChaCha20Rng


def get_inv_from_rng_arr(params: Params, rng: ChaCha20Rng, count: int) -> np.ndarray:
    """Q - (u64 % Q) per draw (client.rs:47-49); 0 maps to Q, as in the ref."""
    vals = rng.next_u64(count)
    return U64(params.modulus) - (vals % U64(params.modulus))


def serialize_polymatrix_excl_first_row(a: np.ndarray) -> bytes:
    """Raw matrix (rows, cols, poly_len) → bytes of rows 1.. as LE u64."""
    return a[1:].astype("<u8").tobytes()


def deserialize_polymatrix_rng(params: Params, rows: int, cols: int,
                               data: bytes, rng: ChaCha20Rng) -> tuple[np.ndarray, int]:
    """Rebuild a raw matrix: first row from the rng, the rest from `data`.
    Returns (matrix, bytes_consumed)."""
    out = np.zeros((rows, cols, params.poly_len), dtype=U64)
    out[0] = get_inv_from_rng_arr(params, rng, cols * params.poly_len).reshape(
        cols, params.poly_len)
    nbytes = (rows - 1) * cols * params.poly_len * 8
    rest = np.frombuffer(data[:nbytes], dtype="<u8").astype(U64)
    out[1:] = rest.reshape(rows - 1, cols, params.poly_len)
    return out, nbytes


def reorient_reg_ciphertexts(params: Params, v_reg: list[np.ndarray]) -> np.ndarray:
    """NTT-domain (2,1) Regev cts → packed u64 buffer laid out [z][j][r] with
    channel-0 residue in the low 32 bits and channel-1 in the high 32
    (util.rs:323-355)."""
    num = len(v_reg)
    out = np.zeros((params.poly_len, num, 2), dtype=U64)
    for j, ct in enumerate(v_reg):
        # ct: (2, 1, crt, poly_len)
        v1 = ct[:, 0, 0, :] % U64(params.moduli[0])  # (2, poly_len)
        v2 = ct[:, 0, 1, :] % U64(params.moduli[1])
        out[:, j, :] = (v1 | (v2 << U64(32))).T
    return out.reshape(-1)


@dataclass
class PublicParameters:
    v_packing: list[np.ndarray] = field(default_factory=list)  # NTT (n+1, t_conv)
    v_expansion_left: list[np.ndarray] | None = None
    v_expansion_right: list[np.ndarray] | None = None
    v_conversion: list[np.ndarray] | None = None  # NTT (2, 2*t_conv)
    seed: bytes | None = None

    def serialize(self, params: Params) -> bytes:
        data = bytearray()
        if self.seed is not None:
            data.extend(self.seed)
        groups = [self.v_packing, self.v_expansion_left,
                  self.v_expansion_right, self.v_conversion]
        for grp in groups:
            if grp is None:
                continue
            for m in grp:
                raw = poly.from_ntt(params, m)
                data.extend(serialize_polymatrix_excl_first_row(raw))
        return bytes(data)

    @staticmethod
    def deserialize(params: Params, data: bytes) -> "PublicParameters":
        assert params.setup_bytes() == len(data), (params.setup_bytes(), len(data))
        idx = 0
        seed = data[:SEED_LENGTH]
        rng = ChaCha20Rng(seed)
        idx += SEED_LENGTH

        def read_vec(num, rows, cols):
            nonlocal idx
            out = []
            for _ in range(num):
                m, consumed = deserialize_polymatrix_rng(params, rows, cols, data[idx:], rng)
                idx += consumed
                out.append(poly.to_ntt(params, m))
            return out

        v_packing = read_vec(params.n, params.n + 1, params.t_conv)
        pp = PublicParameters(v_packing=v_packing, seed=seed)
        if params.expand_queries:
            v_left = read_vec(params.g(), 2, params.t_exp_left)
            if params.version == 0 or params.t_exp_right != params.t_exp_left:
                v_right = read_vec(params.stop_round() + 1, 2, params.t_exp_right)
            else:
                v_right = v_left
            v_conv = read_vec(1, 2, 2 * params.t_conv)
            pp.v_expansion_left = v_left
            pp.v_expansion_right = v_right
            pp.v_conversion = v_conv
        return pp


@dataclass
class Query:
    ct: np.ndarray | None = None        # raw (2, 1, poly_len)
    v_buf: np.ndarray | None = None     # packed u64 reoriented buffer
    v_ct: list[np.ndarray] | None = None  # raw (2, 2*t_gsw, poly_len) per dim
    seed: bytes | None = None

    def serialize(self, params: Params) -> bytes:
        data = bytearray()
        if self.seed is not None:
            data.extend(self.seed)
        if self.ct is not None:
            data.extend(serialize_polymatrix_excl_first_row(self.ct))
        if self.v_buf is not None:
            data.extend(self.v_buf[1::2].astype("<u8").tobytes())
        if self.v_ct is not None:
            for m in self.v_ct:
                data.extend(serialize_polymatrix_excl_first_row(m))
        return bytes(data)

    @staticmethod
    def deserialize(params: Params, data: bytes) -> "Query":
        assert params.query_bytes() == len(data)
        out = Query()
        out.seed = data[:SEED_LENGTH]
        rng = ChaCha20Rng(out.seed)
        data = data[SEED_LENGTH:]
        if params.expand_queries:
            ct, _ = deserialize_polymatrix_rng(params, 2, 1, data, rng)
            out.ct = ct
        else:
            v_buf_bytes = params.query_v_buf_bytes()
            v_buf = np.frombuffer(data[:v_buf_bytes], dtype="<u8").astype(U64)
            # regenerate the pseudorandom halves and interleave (client.rs:105-128)
            reg_cts = []
            for _ in range(params.num_expanded()):
                sigma = poly.raw_zero(params, 2, 1)
                sigma[0, 0] = get_inv_from_rng_arr(params, rng, params.poly_len)
                reg_cts.append(poly.to_ntt(params, sigma))
            reg_buf = reorient_reg_ciphertexts(params, reg_cts)
            interleaved = np.empty(2 * len(v_buf), dtype=U64)
            interleaved[0::2] = reg_buf[0::2]
            interleaved[1::2] = v_buf
            out.v_buf = interleaved
            idx = v_buf_bytes
            v_ct = []
            for _ in range(params.db_dim_2):
                m, consumed = deserialize_polymatrix_rng(
                    params, 2, 2 * params.t_gsw, data[idx:], rng)
                idx += consumed
                v_ct.append(m)
            out.v_ct = v_ct
        return out


def reframe_decoded_row(params: Params, decoded: bytes) -> bytes:
    """Recover the row bytes from a decoded response when logp != 8.

    raw_to_bytes (reference poly.rs:213-235) floor-aligns the bit cursor
    after each poly, so each chunk occupies floor(modp_words*logp/8) bytes
    of which the first bytes_per_chunk are the ingested payload
    (kv/ingest.chunk_bytes_to_modp_words). logp == 8 is the identity."""
    from .arith import log2_exact

    logp = log2_exact(params.pt_modulus)
    if logp == 8:
        return decoded
    seg = (params.modp_words_per_chunk() * logp) // 8
    bpc = params.bytes_per_chunk()
    chunks = params.instances * params.n * params.n
    out = bytearray()
    for c in range(chunks):
        out.extend(decoded[c * seg : c * seg + bpc])
    return bytes(out)


class Client:
    """Spiral client (lib/spiral-rs/src/client.rs:361-811)."""

    def __init__(self, params: Params):
        self.params = params
        self.sk_gsw = poly.raw_zero(params, params.n, 1)
        self.sk_reg = poly.raw_zero(params, 1, 1)
        self.dg = DiscreteGaussian(params.noise_width)

    # --- secret keys ---

    def _gen_ternary_mat(self, mat: np.ndarray, hamming: int, rng: ChaCha20Rng):
        params = self.params
        for r in range(mat.shape[0]):
            for c in range(mat.shape[1]):
                pol = np.zeros(params.poly_len, dtype=U64)
                pol[:hamming] = 1
                pol[hamming : 2 * hamming] = params.modulus - 1
                # Fisher-Yates with u64 draws (our own derivation; the Rust
                # client's shuffle consumes randomness differently, so secret
                # seeds are not portable across implementations — public wire
                # formats are unaffected).
                n = len(pol)
                draws = rng.next_u64(n - 1)
                for i in range(n - 1, 0, -1):
                    j = int(draws[n - 1 - i] % U64(i + 1))
                    pol[i], pol[j] = pol[j], pol[i]
                mat[r, c] = pol

    def generate_secret_keys_from_seed(self, seed: bytes):
        rng = ChaCha20Rng(seed)
        self._gen_ternary_mat(self.sk_gsw, HAMMING_WEIGHT, rng)
        self._gen_ternary_mat(self.sk_reg, HAMMING_WEIGHT, rng)

    def generate_secret_keys(self):
        self.generate_secret_keys_from_seed(os.urandom(32))

    # --- encryption primitives ---

    def _noise(self, rows, cols, rng):
        return self.dg.sample_matrix(self.params, rows, cols, rng)

    def get_fresh_gsw_public_key(self, m: int, rng, rng_pub) -> np.ndarray:
        """(n+1, m) raw: row0 = -a, rows 1.. = e + sk_gsw * a (client.rs:401-417)."""
        params = self.params
        a = poly.random_raw_from_rng(params, 1, m, rng_pub)
        e = self._noise(params.n, m, rng)
        b = poly.multiply(params, poly.to_ntt(params, self.sk_gsw),
                          poly.to_ntt(params, a))
        b = poly.add(params, poly.to_ntt(params, e), b)
        a_inv = poly.invert_raw(params, a)
        return poly.stack(a_inv, poly.from_ntt(params, b))

    def get_regev_sample(self, rng, rng_pub) -> np.ndarray:
        """(2, 1) NTT Regev encryption of zero (client.rs:419-433)."""
        params = self.params
        a = poly.random_raw_from_rng(params, 1, 1, rng_pub)
        e = self._noise(1, 1, rng)
        b = poly.multiply(params, poly.to_ntt(params, self.sk_reg),
                          poly.to_ntt(params, a))
        b = poly.add(params, poly.to_ntt(params, e), b)
        neg_a = poly.to_ntt(params, poly.invert_raw(params, a))
        return poly.stack(neg_a, b)

    def get_fresh_reg_public_key(self, m: int, rng, rng_pub) -> np.ndarray:
        cols = [self.get_regev_sample(rng, rng_pub) for _ in range(m)]
        return np.concatenate(cols, axis=1)

    def encrypt_matrix_gsw(self, ag_ntt: np.ndarray, rng, rng_pub) -> np.ndarray:
        """ag: (n, m) NTT plaintext rows; returns (n+1, m) NTT ct."""
        params = self.params
        mx = ag_ntt.shape[1]
        p = self.get_fresh_gsw_public_key(mx, rng, rng_pub)
        return poly.add(params, poly.to_ntt(params, p),
                        poly.pad_top(params, ag_ntt, 1))

    def encrypt_matrix_reg(self, a_ntt: np.ndarray, rng, rng_pub) -> np.ndarray:
        """a: (1, m) NTT plaintext; returns (2, m) NTT Regev ct."""
        m = a_ntt.shape[1]
        p = self.get_fresh_reg_public_key(m, rng, rng_pub)
        return poly.add(self.params, p, poly.pad_top(self.params, a_ntt, 1))

    def decrypt_matrix_reg(self, ct_ntt: np.ndarray) -> np.ndarray:
        """sk_reg_full = [sk | I] (client.rs:332-338), times the ciphertext."""
        sk_full = poly.to_ntt(self.params, np.concatenate(
            [self.sk_reg, poly.raw_identity(self.params, 1, 1)], axis=1))
        return poly.multiply(self.params, sk_full, ct_ntt)

    # --- public parameters (client.rs:540-616) ---

    def generate_keys_from_seed(self, seed: bytes,
                                noise_rng: ChaCha20Rng | None = None,
                                pp_seed: bytes | None = None) -> PublicParameters:
        params = self.params
        self.generate_secret_keys_from_seed(seed)
        rng = noise_rng or ChaCha20Rng(os.urandom(32))
        pp_seed = pp_seed or os.urandom(32)
        rng_pub = ChaCha20Rng(pp_seed)
        pp = PublicParameters(seed=pp_seed)

        sk_reg_ntt = poly.to_ntt(params, self.sk_reg)
        sk_gsw_ntt = poly.to_ntt(params, self.sk_gsw)

        gadget_conv = build_gadget(params, 1, params.t_conv)
        gadget_conv_ntt = poly.to_ntt(params, gadget_conv)
        num_packing_mats = params.n if params.version == 0 else 1
        for i in range(num_packing_mats):
            scaled = poly.scalar_multiply(params, sk_reg_ntt, gadget_conv_ntt)
            ag = poly.ntt_zero(params, params.n, params.t_conv)
            ag[i : i + 1] = scaled
            pp.v_packing.append(self.encrypt_matrix_gsw(ag, rng, rng_pub))

        if params.version > 0:
            scaled = poly.multiply(params, sk_gsw_ntt, gadget_conv_ntt)
            pp.v_packing.append(self.encrypt_matrix_gsw(
                poly.shift_rows_by_one(scaled), rng, rng_pub))

        if params.expand_queries:
            pp.v_expansion_left = self._generate_expansion_params(
                params.g(), params.t_exp_left, rng, rng_pub)
            if params.version == 0 or params.t_exp_right != params.t_exp_left:
                pp.v_expansion_right = self._generate_expansion_params(
                    params.stop_round() + 1, params.t_exp_right, rng, rng_pub)
            else:
                pp.v_expansion_right = None

            g_conv = build_gadget(params, 2, 2 * params.t_conv)
            sk_reg_sq_ntt = poly.multiply(params, sk_reg_ntt, sk_reg_ntt)
            conv = poly.ntt_zero(params, 2, 2 * params.t_conv)
            for i in range(2 * params.t_conv):
                if i % 2 == 0:
                    val = int(g_conv[0, i, 0])
                    sigma = poly.scalar_multiply(
                        params, poly.to_ntt(params, poly.raw_single_value(params, val)),
                        sk_reg_sq_ntt)
                else:
                    val = int(g_conv[1, i, 0])
                    sigma = poly.scalar_multiply(
                        params, poly.to_ntt(params, poly.raw_single_value(params, val)),
                        sk_reg_ntt)
                ct = self.encrypt_matrix_reg(sigma, rng, rng_pub)
                conv[:, i : i + 1] = ct
            pp.v_conversion = [conv]
        return pp

    def generate_keys(self) -> PublicParameters:
        return self.generate_keys_from_seed(os.urandom(32))

    def _generate_expansion_params(self, num_exp: int, m_exp: int, rng, rng_pub):
        params = self.params
        g_exp_ntt = poly.to_ntt(params, build_gadget(params, 1, m_exp))
        res = []
        for i in range(num_exp):
            t = (params.poly_len >> i) + 1
            tau_sk_reg = poly.automorph_raw(params, self.sk_reg, t)
            prod = poly.multiply(params, poly.to_ntt(params, tau_sk_reg), g_exp_ntt)
            res.append(self.encrypt_matrix_reg(prod, rng, rng_pub))
        return res

    # --- query (client.rs:618-721) ---

    def generate_query(self, idx_target: int,
                       noise_rng: ChaCha20Rng | None = None,
                       query_seed: bytes | None = None) -> Query:
        params = self.params
        further_dims = params.db_dim_2
        idx_dim0 = idx_target >> further_dims
        idx_further = idx_target & ((1 << further_dims) - 1)
        scale_k = params.modulus // params.pt_modulus
        bits_per = poly.get_bits_per(params, params.t_gsw)

        rng = noise_rng or ChaCha20Rng(os.urandom(32))
        query = Query()
        query.seed = query_seed or os.urandom(32)
        rng_pub = ChaCha20Rng(query.seed)

        if params.expand_queries:
            sigma = poly.raw_zero(params, 1, 1)[0, 0]
            inv_2_g_first = invert_uint_mod(1 << params.g(), params.modulus)
            inv_2_g_rest = invert_uint_mod(1 << (params.stop_round() + 1), params.modulus)
            if params.db_dim_2 == 0:
                sigma[idx_dim0] = scale_k
                for i in range(params.poly_len):
                    sigma[i] = (int(sigma[i]) * inv_2_g_first) % params.modulus
            else:
                sigma[2 * idx_dim0] = scale_k
                for i in range(further_dims):
                    if (idx_further >> i) & 1:
                        for j in range(params.t_gsw):
                            idx = i * params.t_gsw + j
                            sigma[2 * idx + 1] = 1 << (bits_per * j)
                for i in range(params.poly_len // 2):
                    sigma[2 * i] = (int(sigma[2 * i]) * inv_2_g_first) % params.modulus
                    sigma[2 * i + 1] = (int(sigma[2 * i + 1]) * inv_2_g_rest) % params.modulus
            ct_ntt = self.encrypt_matrix_reg(
                poly.to_ntt(params, sigma.reshape(1, 1, -1)), rng, rng_pub)
            query.ct = poly.from_ntt(params, ct_ntt)
        else:
            num_expanded = 1 << params.db_dim_1
            reg_cts = []
            for i in range(num_expanded):
                value = scale_k if i == idx_dim0 else 0
                sigma = poly.raw_single_value(params, value)
                reg_cts.append(self.encrypt_matrix_reg(
                    poly.to_ntt(params, sigma), rng, rng_pub))
            query.v_buf = reorient_reg_ciphertexts(params, reg_cts)
            sk_reg_ntt = poly.to_ntt(params, self.sk_reg)
            v_ct = []
            for i in range(further_dims):
                bit = (idx_further >> i) & 1
                ct_gsw = poly.raw_zero(params, 2, 2 * params.t_gsw)
                ct_gsw_ntt = poly.ntt_zero(params, 2, 2 * params.t_gsw)
                for j in range(params.t_gsw):
                    value = (1 << (bits_per * j)) * bit
                    sigma_ntt = poly.to_ntt(params, poly.raw_single_value(params, value))
                    prod = poly.multiply(params, sk_reg_ntt, sigma_ntt)
                    ct = self.encrypt_matrix_reg(prod, rng, rng_pub)
                    ct_gsw_ntt[:, 2 * j : 2 * j + 1] = ct
                    ct = self.encrypt_matrix_reg(sigma_ntt, rng, rng_pub)
                    ct_gsw_ntt[:, 2 * j + 1 : 2 * j + 2] = ct
                v_ct.append(poly.from_ntt(params, ct_gsw_ntt))
            query.v_ct = v_ct
        return query

    # --- decode (client.rs:732-810) ---

    def decode_response(self, data: bytes) -> bytes:
        params = self.params
        p = params.pt_modulus
        p_bits = log2_ceil(p)
        q1 = 4 * p
        q1_bits = log2_ceil(q1)
        q2 = Q2_VALUES[params.q2_bits]
        q2_bits = params.q2_bits

        q2_params = params.clone_with_moduli((q2,))

        sk_gsw_q2 = np.zeros((params.n, 1, params.poly_len), dtype=U64)
        flat_sk = self.sk_gsw.reshape(-1)
        flat_out = sk_gsw_q2.reshape(-1)
        for i in range(params.poly_len * params.n):
            flat_out[i] = recenter(int(flat_sk[i]), params.modulus, q2)
        sk_gsw_q2_ntt = poly.to_ntt(q2_params, sk_gsw_q2)

        result = np.zeros((params.instances * params.n, params.n, params.poly_len),
                          dtype=U64)
        bit_offs = 0
        npoly = params.poly_len
        for instance in range(params.instances):
            cnt1 = params.n * npoly
            first_row = read_fields(data, bit_offs, q2_bits, cnt1)
            bit_offs += q2_bits * cnt1
            cnt2 = params.n * params.n * npoly
            rest_rows = read_fields(data, bit_offs, q1_bits, cnt2)
            bit_offs += q1_bits * cnt2

            first_row = first_row.reshape(1, params.n, npoly)
            rest_rows = rest_rows.reshape(params.n, params.n, npoly)

            first_row_q2 = poly.to_ntt(q2_params, first_row)
            sk_prod = poly.from_ntt(
                q2_params, poly.multiply(q2_params, sk_gsw_q2_ntt, first_row_q2))

            vf = sk_prod.astype(np.int64)
            vf = np.where(vf >= q2 // 2, vf - q2, vf)
            vr = rest_rows.astype(np.int64)
            vr = np.where(vr >= q1 // 2, vr - q1, vr)

            denom = q2 * (q1 // p)
            r = vf * q1 + vr * q2
            sign = np.where(r >= 0, 1, -1)
            res = (np.sign(r + sign * (denom // 2)) *
                   (np.abs(r + sign * (denom // 2)) // denom))
            res = (res + (denom // p) * p + 2 * p) % p
            result[instance * params.n : (instance + 1) * params.n] = res.astype(U64)

        return poly.raw_to_bytes(params, result, p_bits, params.modp_words_per_chunk())
