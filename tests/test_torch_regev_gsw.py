"""The regev_to_gsw kernel (csrc/regev_to_gsw.cu: a batch's folding keys and
their negations in one launch) on the CPU: its plain version against the
JAX package's regev_to_gsw + get_v_folding_neg, the pointwise negation its
epilogue stores against the JAX get_v_folding_neg, and a numpy model of its
blocks (cluster split by row, Shoup partial sums, store addresses)
against the plain version. Inputs are made from a seed with numpy; integer results,
tolerance 0."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j, poly as poly_j
from sdk_tpu.ops import spiral_jax as sj
from sdk_tpu_torch.ops import spiral as st
from sdk_tpu_torch.ops.modops import crt_compose, shoup_companion_arr
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)

torch.set_num_threads(1)
U64 = np.uint64
FAST = get_fast_expansion_testing_params()            # t_gsw 8, t_conv 4
TINY = params_from_json(                              # 3 GSW leaves, t_conv 3
    '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 3,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')


def J(params):
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32)
                            .view(np.int32))


def residues(rng, params, lead):
    return np.stack([rng.integers(0, q, lead + (params.poly_len,))
                     for q in params.moduli], axis=-2).astype(U64)


def gadget_ntt(params):
    pj = J(params)
    return poly_j.to_ntt(pj, poly_j.build_gadget(pj, 2, 2 * params.t_gsw))


def case(params, nq: int, seed: int, scattered: bool):
    """Canonical leaves (nq, n_leaves, 2, 1, crt, n) with a zero query
    (query 1; at nq = 1 one zero leaf) and q_c - 1 words planted, each
    query's conversion key (nq, 2, 2 t_conv, crt, n) and its Shoup
    companions, and the GSW leaves' positions (dense or scattered)."""
    rng = np.random.default_rng(seed)
    n_gsw = params.t_gsw * params.db_dim_2
    n_leaves = 2 * n_gsw + 3
    leaves = residues(rng, params, (nq, n_leaves, 2, 1))
    pos = (rng.permutation(n_leaves)[:n_gsw] if scattered
           else np.arange(1, 2 * n_gsw, 2))
    if nq > 1:
        leaves[1] = 0
    else:
        leaves[0, pos[1]] = 0
    for c, q in enumerate(params.moduli):
        leaves[0, pos[0], :, :, c, :16] = q - 1
    w = residues(rng, params, (nq, 2, 2 * params.t_conv))
    return leaves, pos.astype(np.int32), w, shoup_companion_arr(params, w)


def key_sets(w: np.ndarray, ws: np.ndarray) -> list:
    return [{"v_exp_left": [], "v_exp_right": [],
             "v_conversion": (t32(w[i]), t32(ws[i]))} for i in range(len(w))]


@pytest.fixture(scope="module")
def jax_chain():
    """regev_to_gsw then get_v_folding_neg of the JAX package, one jitted
    program a parameter set."""
    progs = {}

    def run(params, v_inp, w, ws):
        key = id(params)
        if key not in progs:
            pj, g = J(params), gadget_ntt(params).astype(np.uint32)

            def chain(v, a, a_s):
                vf = sj.regev_to_gsw(pj, v, (a, a_s))
                return vf, sj.get_v_folding_neg(pj, vf[None], g)[0]
            progs[key] = jax.jit(chain)
        vf, vn = progs[key](*(jnp.asarray(x.astype(np.uint32))
                              for x in (v_inp, w, ws)))
        return (np.asarray(vf).astype(np.int32),
                np.asarray(vn).astype(np.int32))
    return run


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("params", [FAST, TINY], ids=["fast", "tiny"])
def test_fused_plain_matches_jax(jax_chain, params, nq):
    """regev_to_gsw_neg on CPU tensors (the plain A', A, B chain and the
    transform-based negation) equals the JAX package's regev_to_gsw and
    get_v_folding_neg of each query's GSW leaves, dense positions at
    nq = 1 and scattered (a sparse expansion's) at nq = 3."""
    leaves, pos, w, ws = case(params, nq, 70 + nq, scattered=nq > 1)
    vf, vn = st.regev_to_gsw_neg(params, t32(leaves), torch.from_numpy(pos),
                                 st.ExpansionKeys(params, key_sets(w, ws)),
                                 t32(gadget_ntt(params)))
    shape = (nq, params.db_dim_2, 2, 2 * params.t_gsw, params.crt_count,
             params.poly_len)
    assert vf.shape == shape and vn.shape == shape
    for i in range(nq):
        want_f, want_n = jax_chain(params, leaves[i, pos], w[i], ws[i])
        np.testing.assert_array_equal(vf[i].numpy(), want_f)
        np.testing.assert_array_equal(vn[i].numpy(), want_n)
    if nq > 1:                                 # the zero query's inputs
        assert not vf[1, :, :, 1::2].any()


def negate_pointwise(params, v_folding: torch.Tensor,
                     gadget: torch.Tensor) -> torch.Tensor:
    """The kernel's negation: (gadget - v) mod q_c, word by word."""
    q = torch.tensor(params.moduli, dtype=torch.int32).reshape(-1, 1)
    d = gadget - v_folding
    return torch.where(d < 0, d + q, d)


def test_pointwise_negation_matches_jax():
    """The negation the kernel stores, (gadget - v) mod q_c word by word,
    equals the JAX get_v_folding_neg (from_ntt, Q - x, to_ntt, add_mod)
    and the port's transform chain on canonical folding keys with zero and
    q_c - 1 coefficients and an all-zero polynomial."""
    params = FAST
    rng = np.random.default_rng(81)
    vf = residues(rng, params, (2, params.db_dim_2, 2, 2 * params.t_gsw))
    for c, q in enumerate(params.moduli):
        vf[0, 0, 0, 0, c, :64] = 0
        vf[0, 0, 1, 1, c, :64] = q - 1
        vf[1, 0, 0, 2, c, ::3] = q - 1
    vf[1, 1, 1, 3] = 0
    g = gadget_ntt(params)
    want = np.asarray(jax.jit(lambda v: sj.get_v_folding_neg(
        J(params), v, g.astype(np.uint32)))(jnp.asarray(vf.astype(
            np.uint32)))).astype(np.int32)
    got = negate_pointwise(params, t32(vf), t32(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, st.get_v_folding_neg(params, t32(vf), t32(g)))


def shoup(w, ws, y, q):
    """The kernel's lazy Shoup product in wrapping uint32: w*y -
    mulhi(y, w')*q, in [0, 2q)."""
    m = U64(0xFFFFFFFF)
    hi = (y * ws) >> U64(32)
    return ((w * y) & m) - ((hi * U64(q)) & m) & m


def digit_split(t_conv, cluster):
    """The digits kk (digit kk // 2 of row kk % 2) that each block of a
    cluster takes: one block all 2 t_conv; in a cluster of 2, block `rank`
    the t_conv digits of row `rank` (the one row it inverts and
    composes)."""
    if cluster == 1:
        return [list(range(2 * t_conv))]
    return [[2 * k + rank for k in range(t_conv)] for rank in range(2)]


def emulate(params, leaves, pos, w, ws, gad, cluster):
    """The kernel's blocks in numpy, over flat outputs: block b is rank b %
    cluster of (query, leaf) b // cluster; a block takes both rows, or in
    a cluster of 2 row rank: each stores its rows of the input column and
    its negation, composes those rows and forms the
    Shoup sums of its digits (the plain transforms standing in for the
    core), rank 0 adds the partials and stores the product column.
    Returns the outputs and each word's store count."""
    nq, n_gsw, T = len(leaves), len(pos), params.t_gsw
    n, crt = params.poly_len, params.crt_count
    bits = st._get_bits_per(params, params.t_conv)
    mask = (1 << min(bits, 32)) - 1
    row_words = 2 * T * crt * n
    total = nq * params.db_dim_2 * 2 * row_words
    fold = np.zeros(total, dtype=U64)
    neg = np.zeros(total, dtype=U64)
    stores = np.zeros(total, dtype=np.int64)
    split = digit_split(params.t_conv, cluster)
    qs = params.moduli

    def store(o, words, gcol, q):
        fold[o:o + n] = words
        neg[o:o + n] = np.where(gcol >= words, gcol - words,
                                gcol + U64(q) - words)
        stores[o:o + n] += 1

    partials = {}
    for b in range(nq * n_gsw * cluster):
        rank, blk = b % cluster, b // cluster
        qq, leaf = blk // n_gsw, blk % n_gsw
        d, col = leaf // T, 2 * (leaf % T)
        out0 = (qq * params.db_dim_2 + d) * 2 * row_words
        v = leaves[qq, pos[leaf]]                        # (2, 1, crt, n)
        rows = [0, 1] if cluster == 1 else [rank]
        assert all(kk % 2 in rows for kk in split[rank])
        for row in rows:
            for c in range(crt):
                store(out0 + row * row_words + (col + 1) * crt * n + c * n,
                      v[row, 0, c], gad[row, col + 1, c], qs[c])
        raw = crt_compose(params, st.ntt_inverse_plain(
            params, t32(v[:, 0]))).numpy().astype(U64)   # (2, n)
        acc = np.zeros((2, crt, n), dtype=U64)
        for kk in split[rank]:
            off = (kk >> 1) * bits
            dig = (raw[kk & 1] >> U64(off)) & U64(mask) if off < 64 \
                else np.zeros(n, dtype=U64)
            y = st.ntt_forward_plain(params, t32(np.stack([dig, dig]) % np.array(
                qs, dtype=U64)[:, None])).numpy().astype(U64)
            for row in range(2):
                for c, q in enumerate(qs):
                    t = acc[row, c] + shoup(w[qq, row, kk, c], ws[qq, row, kk, c],
                                            y[c], q)
                    acc[row, c] = np.where(t >= 2 * q, t - U64(2 * q), t)
                    assert (acc[row, c] < 2 * q).all()
        partials.setdefault(blk, []).append(acc)
    for blk, parts in partials.items():
        qq, leaf = blk // n_gsw, blk % n_gsw
        d, col = leaf // T, 2 * (leaf % T)
        out0 = (qq * params.db_dim_2 + d) * 2 * row_words
        s = sum(parts)
        assert (s < U64(1 << 31)).all()          # 2 partials < 4q, 32 bits
        for row in range(2):
            for c, q in enumerate(qs):
                store(out0 + row * row_words + col * crt * n + c * n,
                      s[row, c] % U64(q), gad[row, col, c], q)
    return fold, neg, stores


@pytest.mark.parametrize("cluster", [1, 2])
def test_kernel_model_matches_plain(cluster):
    """The numpy model of the kernel's blocks, at every cluster form, on
    two queries (one all zero) with scattered leaf positions: every output
    word is stored exactly once, every partial sum stays below 2q and their
    total below 2^31, and the outputs equal regev_to_gsw_neg_plain."""
    params = TINY
    leaves, pos, w, ws = case(params, 2, 90 + cluster, scattered=True)
    gad = gadget_ntt(params)
    fold, neg, stores = emulate(params, leaves, pos, w, ws, gad, cluster)
    assert (stores == 1).all()
    want_f, want_n = st.regev_to_gsw_neg_plain(
        params, t32(leaves), torch.from_numpy(pos),
        st.ExpansionKeys(params, key_sets(w, ws)), t32(gad))
    np.testing.assert_array_equal(fold.astype(np.int32),
                                  want_f.numpy().ravel())
    np.testing.assert_array_equal(neg.astype(np.int32),
                                  want_n.numpy().ravel())


def test_tiling_defaults():
    """A cluster of 2 blocks while the (query, leaf) pairs are no more than
    132 SMs (a single read: 42 leaves; three reads: 126), then 1 (a
    16-batch: 672); the digit split takes every digit once, a cluster's
    block the digits of one row."""
    tiling = st.regev_to_gsw_tiling
    assert tiling(42, 132) == 2
    assert tiling(126, 132) == 2
    assert tiling(133, 132) == 1
    assert tiling(672, 132) == 1
    for t_conv in (1, 3, 4):
        for cl in (1, 2):
            split = digit_split(t_conv, cl)
            assert sorted(k for r in split for k in r) == list(
                range(2 * t_conv))
            if cl > 1:
                assert all(k % 2 == rank for rank, r in enumerate(split)
                           for k in r)


def test_key_table_and_launch_checks():
    """The batch's pointer table has one row past the expansion rounds, side
    0 holding each query's conversion key (w, w'); the launch refuses CPU
    tensors and inputs of the wrong form."""
    params = TINY
    leaves, pos, w, ws = case(params, 2, 99, scattered=False)
    sets = key_sets(w, ws)
    keys = st.ExpansionKeys(params, sets)
    table = keys.table("cpu")
    g = params.g()
    assert tuple(table.shape) == (g + 1, 2, 2, 2)
    for i, d in enumerate(sets):
        assert table[g, i, 0].tolist() == [t.data_ptr()
                                           for t in d["v_conversion"]]
        assert not table[g, i, 1].any() and not table[:g, i].any()
    gad = t32(gadget_ntt(params))
    with pytest.raises(ValueError, match="CUDA"):
        st._regev_to_gsw_launch(params, t32(leaves), torch.from_numpy(pos),
                                keys, gad)
    with pytest.raises(ValueError, match="positions"):
        st._regev_to_gsw_launch(params, t32(leaves),
                                torch.from_numpy(pos).long(), keys, gad)
    bad = st.ExpansionKeys(params, [{"v_exp_left": [], "v_exp_right": [],
                                     "v_conversion": t32(w[0])}] * 2)
    with pytest.raises(ValueError, match="keyed"):
        st._regev_to_gsw_launch(params, t32(leaves), torch.from_numpy(pos),
                                bad, gad)
