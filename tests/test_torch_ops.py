"""The port's stage functions (sdk_tpu_torch.ops, plain versions on the CPU)
against the JAX package's on the same numpy-seeded inputs. Integer
arithmetic: every comparison is exact (tolerance 0).

The JAX side runs as its own tests run it: jitted on the CPU (conftest.py).
Small parameter sets keep its compile times short. The port's Params come
from the port's own params module; the JAX side gets the JAX package's
Params of the same JSON (J).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdk_tpu import ntt_host, poly, server_host
from sdk_tpu.client import Client
from sdk_tpu.ops import encode_jax, ntt_jax, spiral_jax as sj
from sdk_tpu.ops.server_jax import (SpiralServerJax, _join_pair_np,
                                    _split_pair_np, pp_to_device)
from sdk_tpu import params as params_j
from sdk_tpu.rng import ChaCha20Rng
from sdk_tpu_torch import convert
from sdk_tpu_torch.ops import encode, ntt, spiral as st
from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits
from sdk_tpu_torch.params import (Q2_VALUES, get_fast_expansion_testing_params,
                                  get_no_expansion_testing_params,
                                  params_from_json, params_to_json_obj)

torch.set_num_threads(1)
U64 = np.uint64
FAST = get_fast_expansion_testing_params()
# version-1 crypto shapes of the 1 GiB bucket (t_gsw 7, t_conv 3, t_exp 5)
V1_TINY = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')
EXP_TINY = params_from_json(
    '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 3,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')


def J(params):
    """The JAX package's Params of the same JSON as the port's ``params``."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def residues(rng, params, lead):
    return np.stack([rng.integers(0, q, lead + (params.poly_len,))
                     for q in params.moduli], axis=-2).astype(U64)


def t32(a: np.ndarray) -> torch.Tensor:
    """uint32-valued array -> int32 tensor of the same bit patterns."""
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def keys(params, seed=0x11):
    c = Client(J(params))
    return c, c.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)


def keyed_pair(params, m: np.ndarray):
    """(JAX (w, w'), port (w, w')) for one key matrix."""
    ws = shoup_companion_arr(params, m)
    return ((jnp.asarray(m.astype(np.uint32)), jnp.asarray(ws)),
            (u32_bits(m, "cpu"), u32_bits(ws, "cpu")))


@pytest.mark.parametrize("kind", ["residues", "digits", "lazy_4q", "any_u32"])
def test_ntt_matches_jax(kind):
    rng = np.random.default_rng(11)
    if kind == "any_u32":
        # the whole uint32 range, as tests/test_ntt_jax.py pins it
        x = rng.integers(0, 1 << 32, (3, 2, FAST.poly_len), dtype=U64)
        x[0, :, :3] = [(1 << 32) - 1, 1 << 31, 4 * FAST.moduli[0]]
    elif kind == "residues":
        x = residues(rng, FAST, (3,))
    elif kind == "digits":
        x = rng.integers(0, 1 << 19, (3, 2, FAST.poly_len)).astype(U64)
    else:
        x = np.stack([rng.integers(0, 4 * q, (3, FAST.poly_len))
                      for q in FAST.moduli], axis=-2).astype(U64)
    x_in = x
    if kind == "any_u32":
        # The port gives the exact transform of x mod q for any uint32. The
        # JAX function (and its host oracle) run their lazy butterflies on
        # whatever they are given: from 4q on their words are not canonical
        # (>= q) and differ from the transform, so the reference here is the
        # JAX transform of the reduced input.
        lazy = np.asarray(jax.jit(lambda a: ntt_jax.ntt_forward(J(FAST), a))(
            jnp.asarray(x.astype(np.uint32))))
        assert (lazy[:, 0] >= FAST.moduli[0]).any()
        x = np.stack([x[:, c] % U64(q) for c, q in enumerate(FAST.moduli)],
                     axis=1)
    fwd = np.asarray(jax.jit(lambda a: ntt_jax.ntt_forward(J(FAST), a))(
        jnp.asarray(x.astype(np.uint32))))
    got = ntt.ntt_forward(FAST, t32(x_in)).numpy()
    np.testing.assert_array_equal(got, fwd.astype(np.int32))
    np.testing.assert_array_equal(got.astype(U64), ntt_host.ntt_forward(J(FAST), x))
    inv = np.asarray(jax.jit(lambda a: ntt_jax.ntt_inverse(J(FAST), a))(
        jnp.asarray(fwd)))
    got_inv = ntt.ntt_inverse(FAST, t32(fwd.astype(U64))).numpy()
    np.testing.assert_array_equal(got_inv, inv.astype(np.int32))
    if kind != "lazy_4q":      # the round trip returns x mod q
        np.testing.assert_array_equal(got_inv.astype(U64), x)


@pytest.mark.parametrize("keyed", [False, True], ids=["plain", "shoup"])
def test_matmul_mod_matches_jax(keyed):
    rng = np.random.default_rng(12)
    for a_lead, b_lead in (((), (4,)), ((3,), (3, 2))):
        a = residues(rng, FAST, a_lead + (2, 6))
        b = residues(rng, FAST, b_lead + (6, 2))
        if keyed:
            a_jax, a_t = keyed_pair(FAST, a)
        else:
            a_jax, a_t = jnp.asarray(a.astype(np.uint32)), t32(a)
        want = np.asarray(jax.jit(lambda x, y: sj.matmul_mod(J(FAST), x, y))(
            a_jax, jnp.asarray(b.astype(np.uint32))))
        got = st.matmul_mod(FAST, a_t, t32(b)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_scan_matches_jax():
    """firstdim_multiply on a DB carried across by convert.db_from_jax_planes
    (the JAX latency-layout limb planes)."""
    from sdk_tpu.ops.server_jax import db_tensor_to_device

    params = FAST
    rng = np.random.default_rng(13)
    dim0, npr = 1 << params.db_dim_1, 1 << params.db_dim_2
    db_host = np.stack([rng.integers(0, q, (params.instances, 4,
                                            params.poly_len, npr, dim0))
                        for q in params.moduli], axis=3).astype(U64)
    planes = db_tensor_to_device(J(params), db_host)
    db = convert.db_from_jax_planes(params, planes)
    assert torch.equal(db, convert.db_from_host_tensor(params, db_host))
    for R in (2, 6):
        q_arr = residues(rng, params, (dim0, R)).transpose(2, 3, 0, 1)
        want = np.asarray(jax.jit(lambda d, q: sj.firstdim_multiply(
            J(params), d, q))(planes, jnp.asarray(q_arr.astype(np.uint32))))
        got = st.firstdim_multiply(params, db, t32(q_arr)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_automorph_gadget_invert_match_jax():
    """Negating zero gives Q (not 0) in automorph_pair and invert_raw_pair,
    and the gadget digits of Q are what the JAX package computes."""
    params = V1_TINY
    rng = np.random.default_rng(14)
    raw = rng.integers(0, params.modulus, (2, 2, 1, params.poly_len),
                       dtype=U64)
    raw[0, 0, 0, :64] = 0
    hi, lo = (jnp.asarray(x) for x in _split_pair_np(raw))
    pj = J(params)
    perm, neg = sj.automorph_tables(pj, params.poly_len // 4 + 1)

    def jax_fn(h, l):
        ah, al = sj.automorph_pair(pj, h, l, perm, neg)
        ih, il = sj.invert_raw_pair(pj, h, l)
        return (ah, al, ih, il, sj.gadget_digits(pj, ah, al, 14, 2),
                sj.gadget_digits(pj, ih[:, :1], il[:, :1], 5, 1))

    ah, al, ih, il, g1, g2 = (np.asarray(x) for x in jax.jit(jax_fn)(hi, lo))
    r = torch.from_numpy(raw.astype(np.int64))
    a = st.automorph_pair(params, r, torch.from_numpy(perm),
                          torch.from_numpy(neg))
    inv = st.invert_raw_pair(params, r)
    assert (inv.numpy() == params.modulus).any()
    np.testing.assert_array_equal(a.numpy().astype(U64), _join_pair_np(ah, al))
    np.testing.assert_array_equal(inv.numpy().astype(U64), _join_pair_np(ih, il))
    np.testing.assert_array_equal(st.gadget_digits(params, a, 14, 2).numpy(),
                                  g1.astype(np.int64))
    np.testing.assert_array_equal(
        st.gadget_digits(params, inv[:, :1], 5, 1).numpy(), g2.astype(np.int64))


@pytest.fixture(scope="module")
def expansion_batch():
    """Three EXP_TINY sessions, each with its own keys and one query (the
    first as test_expansion_matches_jax has always made it), and the JAX
    engine's expand_query of each: one traced JAX expansion for the
    module's single and batched cases."""
    params = EXP_TINY
    assert (params.g(), params.stop_round()) == (4, 2)
    sessions = [keys(params, seed) for seed in (0x11, 0x31, 0x41)]
    queries = [sessions[0][0].generate_query(
        5, noise_rng=ChaCha20Rng(b"\x14" * 32), query_seed=b"\x15" * 32)]
    queries += [c.generate_query(2 * i + 1,
                                 noise_rng=ChaCha20Rng(bytes([0x54 + i]) * 32),
                                 query_seed=bytes([0x64 + i]) * 32)
                for i, (c, _) in enumerate(sessions[1:])]
    srv_j = SpiralServerJax(J(params))
    jax = [tuple(np.asarray(x).astype(np.int32) for x in srv_j.expand_query(
        pp_to_device(J(params), pp), q)) for (_, pp), q in zip(sessions,
                                                              queries)]
    return {"pp": [pp for _, pp in sessions], "queries": queries, "jax": jax}


def test_expansion_matches_jax(expansion_batch):
    """The expansion + regev_to_gsw through both engines' expand_query. EXP_TINY's 4 rounds cover the skip masks: a partial odd
    mask at stop_round (2) and no odd update after it (round 3, where no
    right key exists)."""
    from sdk_tpu_torch.ops.server import SpiralServerTorch

    q_jax, vf_jax = expansion_batch["jax"][0]
    srv = SpiralServerTorch(EXP_TINY, "cpu")
    q_t, vf_t = srv.expand_query(srv._pp_dev(expansion_batch["pp"][0]),
                                 expansion_batch["queries"][0])
    np.testing.assert_array_equal(q_t.numpy(), q_jax)
    np.testing.assert_array_equal(vf_t.numpy(), vf_jax)


def test_batched_expansion_matches_jax(expansion_batch):
    """The batched expansion at NQ = 3, each query with its own keys:
    expand_batch's leaves (one expansion_round a round for the batch, the
    dense schedule) equal each query's expansion alone (NQ = 1, its own
    keys) leaf for leaf and the JAX engine's expansion
    (spiral_jax.coefficient_expansion) on every leaf a read uses (the Regev leaves are its scan columns, the
    GSW leaves the odd columns of its folding keys: regev_to_gsw
    interleaves them verbatim); the engine's expand_queries, padded to
    four column pairs, equals the JAX engine's expand_query of each query
    and repeats query 0's columns, its negated folding keys the
    transform chain's (get_v_folding_neg); expand_query is its one-query
    case."""
    from sdk_tpu_torch.ops.server import SpiralServerTorch

    params = EXP_TINY
    srv = SpiralServerTorch(params, "cpu")
    pps = [srv._pp_dev(pp) for pp in expansion_batch["pp"]]
    queries = expansion_batch["queries"]
    right = params.t_gsw * params.db_dim_2
    dim0 = 1 << params.db_dim_1
    ct0 = st.to_ntt(params, torch.from_numpy(
        np.stack([q.ct for q in queries]).astype(np.int64)))
    schedule = st.dense_schedule(params, right)
    leaves = st.expand_batch(params, srv.plan, schedule, ct0,
                             st.ExpansionKeys(params, pps))
    for i, pp in enumerate(pps):
        assert torch.equal(leaves[i], st.expand_batch(
            params, srv.plan, schedule, ct0[i:i + 1],
            st.ExpansionKeys(params, [pp]))[0])
        q_jax, vf_jax = expansion_batch["jax"][i]
        reg = leaves[i, 0:2 * dim0:2, :, 0].permute(2, 3, 0, 1)
        np.testing.assert_array_equal(reg.numpy(), q_jax)
        gsw = leaves[i, 1:2 * right:2, :, 0].numpy()     # (right, 2, crt, n)
        np.testing.assert_array_equal(gsw, vf_jax[:, :, 1::2].transpose(
            0, 2, 1, 3, 4).reshape(gsw.shape))
    q_all, v_folding, v_neg = srv.expand_queries(pps, queries, 4)
    assert torch.equal(v_neg, st.get_v_folding_neg(
        srv.params, v_folding, srv.gadget_ntt))
    cols = q_all.reshape(q_all.shape[:3] + (4, 2))
    for i, (q_jax, vf_jax) in enumerate(expansion_batch["jax"]):
        np.testing.assert_array_equal(cols[:, :, :, i].numpy(), q_jax)
        np.testing.assert_array_equal(v_folding[i].numpy(), vf_jax)
    assert torch.equal(cols[:, :, :, 3], cols[:, :, :, 0])
    one, vf1 = srv.expand_query(pps[1], queries[1])
    assert torch.equal(one, cols[:, :, :, 1]) and torch.equal(vf1, v_folding[1])


def _fold_fixture():
    """GSW folding keys from a real direct-upload query (as
    tests/test_spiral_jax.py:149)."""
    params = get_no_expansion_testing_params()
    client, _ = keys(params)
    query = client.generate_query(
        5, noise_rng=ChaCha20Rng(b"\x18" * 32), query_seed=b"\x19" * 32)
    pj = J(params)
    v_folding = np.stack([poly.to_ntt(pj, ct) for ct in query.v_ct])
    g_ntt = poly.to_ntt(pj, poly.build_gadget(pj, 2, 2 * params.t_gsw))
    return params, v_folding, g_ntt


def test_fold_sparse_patterns_match_jax():
    """fold_ciphertexts, including the all-zero shortcut: a single planted
    slot comes back verbatim, and mixed zero/populated patterns equal the
    JAX fold (tests/test_spiral_jax.py:172-211 patterns)."""
    params, v_folding, g_ntt = _fold_fixture()
    num_per = 1 << params.db_dim_2
    vf_jax = jnp.asarray(v_folding.astype(np.uint32))
    vfn_jax = jax.jit(lambda v: sj.get_v_folding_neg(
        J(params), v, g_ntt.astype(np.uint32)))(vf_jax)
    fold_jax = jax.jit(lambda h, l: sj.fold_ciphertexts(
        J(params), h, l, vf_jax, vfn_jax))
    vf_t = t32(v_folding)
    vfn_t = st.get_v_folding_neg(params, vf_t, t32(g_ntt))
    np.testing.assert_array_equal(vfn_t.numpy(),
                                  np.asarray(vfn_jax).astype(np.int32))
    rng = np.random.default_rng(10)
    patterns = [{0}, {3}, {num_per - 1}, {1, 4}, {2, 3, 6}, set(range(num_per))]
    for pattern in patterns:
        cts = np.zeros((num_per, 2, 1, params.poly_len), dtype=U64)
        for k in pattern:
            cts[k] = rng.integers(0, params.modulus, (2, 1, params.poly_len),
                                  dtype=U64)
        fh, fl = fold_jax(*(jnp.asarray(x) for x in _split_pair_np(cts)))
        want = _join_pair_np(np.asarray(fh), np.asarray(fl))
        got = st.fold_ciphertexts(params, torch.from_numpy(cts.astype(np.int64)),
                                  vf_t, vfn_t).numpy().astype(U64)
        np.testing.assert_array_equal(got, want)
        if len(pattern) == 1:
            np.testing.assert_array_equal(got, cts[min(pattern)])


@pytest.mark.parametrize("params", [FAST, V1_TINY], ids=["v0", "v1"])
def test_pack_matches_jax(params):
    _, pp = keys(params)
    rng = np.random.default_rng(15)
    v_ct = rng.integers(0, params.modulus, (params.n * params.n, 2, 1,
                                            params.poly_len), dtype=U64)
    pairs = [keyed_pair(params, m) for m in pp.v_packing]
    jax_keys = [p[0] for p in pairs]
    want = np.asarray(jax.jit(lambda h, l, k: sj.pack(J(params), h, l, k))(
        *(jnp.asarray(x) for x in _split_pair_np(v_ct)), jax_keys))
    got = st.pack(params, torch.from_numpy(v_ct.astype(np.int64)),
                  [p[1] for p in pairs]).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("params", [FAST, V1_TINY], ids=["q2_20", "q2_22"])
def test_encode_matches_jax(params):
    plan_jax = encode_jax.ResponseEncodePlan(J(params))
    plan = encode.ResponseEncodePlan(params, "cpu")
    rng = np.random.default_rng(16)
    packed = rng.integers(0, params.modulus, (params.instances, params.n + 1,
                                              params.n, params.poly_len),
                          dtype=U64)
    q = params.modulus
    packed[0, 0, 0, :6] = [0, 1, q // 2 - 1, q // 2, q // 2 + 1, q - 1]
    hi, lo = (jnp.asarray(x) for x in _split_pair_np(packed))
    packed_t = torch.from_numpy(packed.astype(np.int64))
    for out_mod in (Q2_VALUES[params.q2_bits], 4 * params.pt_modulus):
        want = np.asarray(jax.jit(lambda h, l: encode_jax.rescale_pair(
            J(params), h, l, out_mod))(hi, lo))
        got = encode.rescale_pair(params, packed_t, out_mod).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    words = jax.jit(plan_jax.encode)(hi, lo)
    got = plan.to_bytes(plan.encode(packed_t))
    assert got == plan_jax.to_bytes(words)
    assert got == server_host.encode_response(J(params), list(
        packed.astype(U64)))
