"""Kernel G's out_words mode: pack -> from_ntt -> response encode as one
function (``sdk_tpu_torch.ops.spiral.pack_encode``), in its plain version on
the CPU against the JAX package's program for the same stage (what
``SpiralServerJax._pack_encode_impl``, server_jax.py:398, runs: ``pack``,
``from_ntt`` and ``ResponseEncodePlan.encode``), word for word (tolerance
0); and two models of the kernel, numpy and torch only: its schedule (rounds
of side-by-side transforms, rows 1..n summed at their rotated place, row 0
of a version-1 shift kept apart) against ``pack_queries_plain``, and its
word-ownership map (each block's word ranges and its segment bit-pack)
against the whole response's bit stream.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu.ops import encode_jax, spiral_jax as sj
from sdk_tpu.ops.server_jax import _split_pair_np
from sdk_tpu_torch.ops import spiral as st
from sdk_tpu_torch.ops.encode import ResponseEncodePlan
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_from_json_obj,
                                  params_to_json_obj)
from sdk_tpu_torch.params_store import BASE_SHAPES, get_params_from_store

torch.set_num_threads(1)
U64 = np.uint64
FAST = get_fast_expansion_testing_params()            # n 2, version 0
# version-1 crypto shapes of the 1 GiB bucket (t_conv 3), 2 instances
V1_TINY = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 2,'
    ' "version": 1}')


def small(n: int, version: int, t_conv: int):
    """An n x n shape at a small scale: 1 instance, 16 items."""
    return params_from_json(json.dumps(
        {"n": n, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,
         "t_conv": t_conv, "t_exp_left": 8, "t_exp_right": 8,
         "instances": 1, "version": version}))


def J(params):
    """The JAX package's Params of the same JSON as the port's ``params``."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def pack_inputs(params, nq: int, seed: int):
    """Folded cts (nq, instances, n*n, 2, 1, z) and per-query key lists of
    random (n+1, t_conv, 2, z) residues, from a numpy seed; query 0 holds an
    all-zero scalar ct, the last query the values 0, Q-1 and Q/2 in both
    rows of its first ct."""
    rng = np.random.default_rng(seed)
    n, z = params.n, params.poly_len
    v_ct = rng.integers(0, params.modulus,
                        (nq, params.instances, n * n, 2, 1, z), dtype=U64)
    v_ct[0, 0, 1] = 0
    v_ct[-1, 0, 0, :, 0, :3] = [0, params.modulus - 1, params.modulus // 2]
    nkeys = n if params.version == 0 else 2
    keys = [[np.stack([rng.integers(0, q, (n + 1, params.t_conv, z))
                       for q in params.moduli], axis=-2).astype(np.uint32)
             for _ in range(nkeys)] for _ in range(nq)]
    return v_ct, keys


@pytest.fixture(scope="module")
def jax_pack_encode():
    """One jitted JAX program per parameter set: pack, from_ntt and the
    encode of one query's instances (server_jax.py:385-403)."""
    programs = {}

    def get(params):
        key = json.dumps(params_to_json_obj(params), sort_keys=True)
        if key not in programs:
            pj = J(params)
            plan = encode_jax.ResponseEncodePlan(pj)

            def run(h, l, keys):
                hs, ls = [], []
                for i in range(pj.instances):
                    ph, pl = sj.from_ntt(pj, sj.pack(pj, h[i], l[i], keys))
                    hs.append(ph)
                    ls.append(pl)
                return plan.encode(jnp.stack(hs), jnp.stack(ls))

            programs[key] = jax.jit(run)
        return programs[key]

    return get


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("params", [FAST, V1_TINY], ids=["v0", "v1"])
def test_pack_encode_matches_jax(params, nq, jax_pack_encode):
    """The fused plain function (what _pack_encode runs on a CPU tensor)
    equals the JAX package's pack -> from_ntt -> encode, word for word, with
    every query's own keys."""
    v_ct, keys = pack_inputs(params, nq, 61 + nq)
    run = jax_pack_encode(params)
    want = np.stack([np.asarray(run(
        *(jnp.asarray(x) for x in _split_pair_np(v_ct[i])),
        [jnp.asarray(k) for k in keys[i]])) for i in range(nq)])
    plan = ResponseEncodePlan(params, "cpu")
    keys_t = [[torch.from_numpy(k.view(np.int32)) for k in ks] for ks in keys]
    v_ct_t = torch.from_numpy(v_ct.astype(np.int64))
    got = st.pack_encode(params, v_ct_t, keys_t, plan)
    assert got.dtype == torch.int32 and got.shape == (nq, plan.num_words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(np.uint32))
    assert torch.equal(got, st.pack_encode_plain(params, v_ct_t, keys_t, plan))


# ---- a model of kernel G's schedule (csrc/pack.cu) ------------------------

def schedule_model(params, v_ct: torch.Tensor, keys: list, pairs: int,
                   cluster: int) -> torch.Tensor:
    """Kernel G's dataflow for one query in plain torch: per r, rounds of
    ``pairs`` transforms (to_ntt of ct[1], the gadget digits of ct[0]) whose
    key products each block thread adds into its own words, rows 1..n
    straight into v_int at the row they reach after the remaining shift
    steps and, for version 1 with r > 0, row 0 into prod0; a shift step is
    from_ntt(prod0), its digits' transforms in rounds, and the w_shift
    products, row 0 into prod0 or, at the last step, v_int[0]. With
    ``cluster`` = n each r runs in a block of its own, whose partial v_int
    the cluster sums. A block's sums start as garbage, as shared memory
    does, and are overwritten where the kernel starts a sum afresh. Returns
    the packed NTT (instances, n+1, n, crt, z) int32."""
    n, tc = params.n, params.t_conv
    rows = n + 1
    qs = torch.tensor(params.moduli, dtype=torch.int64)[:, None]
    keys = [k.long() for k in keys]

    def rotated(row, k):
        return (row - 1 + k) % n + 1

    def to_ntt(raw):                    # raw (z,) values -> (2, z) int64
        return st._to_ntt_plain(params, raw[None])[0].long()

    def digits(raw):                    # the t_conv gadget digits of raw
        return st.gadget_digits(params, raw[None, None], tc, 1)[:, 0]

    def combine(dst_of, tasks, key):
        """One round's combine: tasks [(digit k, or None for ct[1], its
        transform y)]; dst_of(row) -> (buffer, index, takes ct[1], starts
        from zero)."""
        for row in range(rows):
            buf, idx, ct2, fresh = dst_of(row)
            acc = torch.zeros_like(buf[idx]) if fresh else buf[idx].clone()
            for k, y in tasks:
                if k is None:
                    if ct2:
                        acc = acc + y
                else:
                    acc = acc + key[row, k] * y
            buf[idx] = acc % qs

    def garbage(shape):
        return torch.full(shape, 0x5A5A5A5, dtype=torch.int64)

    def block(inst, col, r_range):
        v_int = garbage((rows, 2, params.poly_len))
        prod0 = garbage((1, 2, params.poly_len))
        for r in r_range:
            ct = v_ct[inst, r * n + col, :, 0]
            key = keys[r] if params.version == 0 else keys[0]
            ct2_row = 1 + r if params.version == 0 else rotated(1, r)
            d = digits(ct[0])
            work = [(None, to_ntt(ct[1]))] + [(k, to_ntt(d[k]))
                                              for k in range(tc)]
            for t0 in range(0, 1 + tc, pairs):
                def dst(row, t0=t0):
                    if params.version != 0 and r > 0 and row == 0:
                        return prod0, 0, False, t0 == 0
                    dr = row if params.version == 0 or row == 0 \
                        else rotated(row, r)
                    return v_int, dr, dr == ct2_row, \
                        t0 == 0 and r == r_range[0]
                combine(dst, work[t0:t0 + pairs], key)
            for s in range(r if params.version else 0):
                res = st._from_ntt_plain(params, prod0.int())[0]
                d = digits(res)
                work = [(k, to_ntt(d[k])) for k in range(tc)]
                for t0 in range(0, tc, pairs):
                    def dst(row, t0=t0, last=s == r - 1, s=s):
                        if row == 0:
                            return ((v_int, 0, False,
                                     t0 == 0 and cluster > 1) if last
                                    else (prod0, 0, False, t0 == 0))
                        return v_int, rotated(row, r - 1 - s), False, False
                    combine(dst, work[t0:t0 + pairs], keys[1])
        return v_int

    out = []
    for inst in range(params.instances):
        cols = []
        for col in range(n):
            if cluster == 1:
                cols.append(block(inst, col, range(n)))
            else:
                cols.append(sum(block(inst, col, range(r, r + 1))
                                for r in range(n)) % qs)
        out.append(torch.stack(cols, dim=1))
    return torch.stack(out).int()


@pytest.mark.parametrize("params", [FAST, V1_TINY, small(4, 0, 4),
                                    small(4, 1, 3), small(3, 1, 2)],
                         ids=["n2_v0", "n2_v1", "n4_v0", "n4_v1", "n3_v1"])
@pytest.mark.parametrize("form", ["block", "cluster"])
def test_pack_schedule_model(params, form):
    """The kernel's schedule, in either form at the pair count pack_tiling
    derives, gives pack_queries_plain's words: the shift steps' rotation of
    rows 1..n is folded into where each product lands, and each sum starts
    afresh where the kernel's does."""
    v_ct, keys = pack_inputs(params, 1, 71)
    v_ct_t = torch.from_numpy(v_ct.astype(np.int64))
    keys_t = [[torch.from_numpy(k.view(np.int32)) for k in ks] for ks in keys]
    want = st.pack_queries_plain(params, v_ct_t, keys_t)[0]
    tl = st.pack_tiling(params, 1, 132,
                        params.n if form == "cluster" else 1)
    got = schedule_model(params, v_ct_t[0], keys_t[0], tl.pairs, tl.cluster)
    assert torch.equal(got, want)


def test_pack_tiling_form_from_the_batch():
    """pack_tiling takes a cluster of n blocks a (query, instance, column)
    while the clusters' blocks fit one wave of the card's SMs, else one
    block."""
    params = get_params_from_store(15, 32768)          # 4 instances, n 2
    assert st.pack_tiling(params, 1, 132) == (4, 2)
    assert st.pack_tiling(params, 8, 132) == (4, 2)
    assert st.pack_tiling(params, 9, 132) == (4, 1)
    assert st.pack_tiling(params, 16, 132) == (4, 1)
    with pytest.raises(ValueError):
        st.pack_tiling(params, 1, 132, 3)


# ---- the word-ownership map -------------------------------------------------

def store_shapes():
    """A Params of each parameter-store shape at the 1 GiB bucket's scale
    (nu_1 9, nu_2 6, 32 KiB items), and the test params."""
    out = {"bucket_1gib": get_params_from_store(15, 32768)}
    for shape in BASE_SHAPES:
        obj = dict(shape, nu_1=9, nu_2=6, p=256, db_item_size=32768,
                   instances=max(1, 32768 // (shape["n"] ** 2 * 2048)))
        out[f"n{shape['n']}_v{shape['version']}"] = params_from_json_obj(obj)
    out["fast"] = FAST
    out["v1_tiny"] = V1_TINY
    return out


def word_ranges(params, plan) -> list[tuple]:
    """The words of one query's response that each block of kernel G writes
    in out_words mode (csrc/pack.cu): (instance, row, column, first word,
    end word); row 0, column c at inst_off + c * z q2_bits / 32, row r >= 1
    at inst_off + (n z q2_bits + ((r-1) n + c) z q1_bits) / 32."""
    n, z = params.n, params.poly_len
    seg0, seg1 = z * plan.q2_bits // 32, z * plan.q1_bits // 32
    inst_words = n * seg0 + n * n * seg1
    out = []
    for inst in range(params.instances):
        off = inst * inst_words
        for row in range(n + 1):
            for col in range(n):
                start = off + (col * seg0 if row == 0
                               else n * seg0 + ((row - 1) * n + col) * seg1)
                out.append((inst, row, col, start,
                            start + (seg0 if row == 0 else seg1)))
    return out


def segment_words(vals: np.ndarray, b: int) -> np.ndarray:
    """Kernel G's bit-pack of one segment (csrc/pack.cu, the out_words
    loop): word w takes bits 32w .. 32w+31 of the segment's LSB-first stream
    of b-bit values."""
    out = np.zeros(len(vals) * b // 32, dtype=np.uint64)
    for w in range(len(out)):
        bit = 32 * w
        i = bit // b
        filled = b - bit % b
        word = int(vals[i]) >> (bit % b)
        while filled < 32:
            i += 1
            word |= int(vals[i]) << filled
            filled += b
        out[w] = word & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("name", list(store_shapes()))
def test_pack_word_ranges_tile_the_response(name):
    """The blocks' word ranges are disjoint and cover [0, num_words)
    exactly, and each block's segment bit-pack of its rescaled values gives
    the words of the whole stream at that range."""
    params = store_shapes()[name]
    plan = ResponseEncodePlan(params, "cpu")
    ranges = word_ranges(params, plan)
    assert len(ranges) == params.instances * (params.n + 1) * params.n
    spans = sorted((a, b) for *_, a, b in ranges)
    assert spans[0][0] == 0 and spans[-1][1] == plan.num_words
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    assert plan.num_words * 32 == plan.num_bits          # no padding word
    # random field values in the stream's order; the stream's words
    rng = np.random.default_rng(81)
    n, z = params.n, params.poly_len
    width = {0: plan.q2_bits, 1: plan.q1_bits}
    vals = {(i, row, col): rng.integers(
        0, plan.q2_val if row == 0 else plan.q1_val, z, dtype=np.int64)
        for i, row, col, *_ in ranges}
    bits = np.concatenate([
        ((vals[key][:, None] >> np.arange(width[key[1] > 0])) & 1).reshape(-1)
        for key in sorted(vals)])
    stream = (bits.reshape(-1, 32) << np.arange(32)).sum(axis=1)
    for i, row, col, a, b in ranges:
        np.testing.assert_array_equal(
            segment_words(vals[(i, row, col)], width[row > 0]), stream[a:b])


# ---- the encode arithmetic of csrc/encode_device.cuh ------------------------

M32 = (1 << 32) - 1


def _umulhi(a, b):
    return (a * b) >> np.uint64(32)


def _shoup(w: int, q: int) -> int:
    return (w << 32) // q


def _mulmod_shoup(w, ws, y, q):
    """w * y mod q by a Shoup word, in wrapping 32-bit arithmetic."""
    r = (w * y - _umulhi(y, np.uint64(ws)) * np.uint64(q)) & np.uint64(M32)
    return np.where(r >= q, r - np.uint64(q), r)


def _reduce32(x, q, m):
    r = (x - _umulhi(x, np.uint64(m)) * np.uint64(q)) & np.uint64(M32)
    return np.where(r >= q, r - np.uint64(q), r)


def device_compose_rescale(params, x: np.ndarray, out_mod: int):
    """csrc/encode_device.cuh compose and rescale on x in [0, Q), from its
    residues, in numpy uint64 arrays masked to 32 bits where the kernel's
    words wrap."""
    q0, q1 = params.moduli
    inv = params.inv_q0_mod_q1
    m1 = (1 << 32) // q1
    h = params.modulus // 2
    qinv = pow(params.modulus, -1, 1 << 32)
    u = np.uint64
    x0, x1 = x % u(q0), x % u(q1)
    d = (x1 + u(q1) - _reduce32(x0, q1, m1))
    d = np.where(d >= q1, d - u(q1), d)
    t = _mulmod_shoup(u(inv), _shoup(inv, q1), d, q1)
    composed = x0 + u(q0) * t
    v = []
    for xc, qc, hc in ((x0, q0, h % q0), (x1, q1, h % q1)):
        w = out_mod % qc
        vc = _mulmod_shoup(u(w), _shoup(w, qc), xc, qc) + u(hc)
        v.append(np.where(vc >= qc, vc - u(qc), vc))
    d = v[1] + u(q1) - _reduce32(v[0], q1, m1)
    d = np.where(d >= q1, d - u(q1), d)
    t = _mulmod_shoup(u(inv), _shoup(inv, q1), d, q1)
    n_mod_q_lo = (v[0] + u(q0) * t) & u(M32)
    low32_n = ((composed & u(M32)) * u(out_mod) + u(h & M32)) & u(M32)
    r = ((low32_n - n_mod_q_lo) & u(M32)) * u(qinv) & u(M32)
    return composed, np.where(r >= out_mod, r - u(out_mod), r)


@pytest.mark.parametrize("params", [FAST, V1_TINY], ids=["q2_20", "q2_22"])
def test_device_encode_arithmetic(params):
    """The kernels' 32-bit Shoup compose and rescale equal the exact
    composition and the port's rescale_pair, edges included."""
    from sdk_tpu_torch.ops.encode import rescale_pair
    from sdk_tpu_torch.params import Q2_VALUES

    rng = np.random.default_rng(91)
    q = params.modulus
    x = rng.integers(0, q, 200000, dtype=U64)
    x[:8] = [0, 1, q // 2 - 1, q // 2, q // 2 + 1, q - 2, q - 1,
             params.moduli[0]]
    xt = torch.from_numpy(x.astype(np.int64))
    for out_mod in (Q2_VALUES[params.q2_bits], 4 * params.pt_modulus):
        composed, got = device_compose_rescale(params, x, out_mod)
        np.testing.assert_array_equal(composed, x)
        np.testing.assert_array_equal(
            got, rescale_pair(params, xt, out_mod).numpy().astype(U64))


def test_combine_reduction():
    """Kernel G's combine reduces a 64-bit sum mod q in 32-bit operations
    (csrc/pack.cu Reducer): hi (2^32 mod q) by a Shoup product plus lo by a
    quotient estimate, then two subtractions; exact for any 64-bit sum."""
    rng = np.random.default_rng(93)
    acc = rng.integers(0, 1 << 63, 200000, dtype=U64) * U64(2) \
        + rng.integers(0, 2, 200000, dtype=U64)
    acc[:4] = [0, (1 << 64) - 1, 1 << 32, (1 << 32) - 1]
    for q in FAST.moduli:
        r32 = (1 << 32) % q
        hi, lo = acc >> U64(32), acc & U64(M32)
        t1 = (U64(r32) * hi - _umulhi(hi, U64(_shoup(r32, q))) * U64(q)) \
            & U64(M32)
        t2 = (lo - _umulhi(lo, U64((1 << 32) // q)) * U64(q)) & U64(M32)
        assert (t1 < 2 * q).all() and (t2 < 2 * q).all()
        t = t1 + t2
        t = np.where(t >= 2 * q, t - U64(2 * q), t)
        t = np.where(t >= q, t - U64(q), t)
        np.testing.assert_array_equal(t, acc % U64(q))
