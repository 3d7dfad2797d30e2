"""The functions that kernels F (fold round), G (pack) and H (ingest) carry,
in their plain versions on the CPU, against the JAX package's on the same
numpy-seeded inputs. Integer arithmetic: every comparison is exact
(tolerance 0).

The JAX side runs as its own tests run it: jitted on the CPU. One JAX
compile per case; the batched forms (per-query key dims, several queries
and instances in one call) are what the port's engine launches once per
batch.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu import poly
from sdk_tpu.client import Client
from sdk_tpu.kv import ingest as ingest_jax
from sdk_tpu.ops import spiral_jax as sj
from sdk_tpu.ops.server_jax import _join_pair_np, _split_pair_np
from sdk_tpu.rng import ChaCha20Rng
from sdk_tpu_torch.kv import ingest as ingest_t
from sdk_tpu_torch.ops import spiral as st
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  get_no_expansion_testing_params,
                                  params_from_json, params_to_json_obj)

torch.set_num_threads(1)
U64 = np.uint64
FAST = get_fast_expansion_testing_params()
# version-1 crypto shapes of the 1 GiB bucket (t_gsw 7, t_conv 3), 2 instances
V1_TINY = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 2,'
    ' "version": 1}')
# a plaintext modulus below a byte: 4-bit fields, two coefficients a byte
P16 = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 16, "q2_bits": 20, "t_gsw": 8,'
    ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
    ' "version": 0}')


def J(params):
    """The JAX package's Params of the same JSON as the port's ``params``."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def client_keys(params, seed: int):
    c = Client(J(params))
    return c, c.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)


def folding_keys(params, seeds):
    """(NQ, db_dim_2, 2, 2*t_gsw, crt, n) GSW folding keys of real
    direct-upload queries, one client per seed."""
    pj = J(params)
    out = []
    for seed in seeds:
        client, _ = client_keys(params, seed)
        query = client.generate_query(
            seed % 7, noise_rng=ChaCha20Rng(bytes([seed + 3]) * 32),
            query_seed=bytes([seed + 4]) * 32)
        out.append(np.stack([poly.to_ntt(pj, ct) for ct in query.v_ct]))
    return np.stack(out)


def planted_cts(rng, params, lead, zero_a=(), zero_b=(), zero_both=()):
    """Raw cts (*lead, num_per, 2, 1, n) with chosen slots of the first
    round's a half, b half or both set to exactly zero, in every entry."""
    num_per = 1 << params.db_dim_2
    cts = rng.integers(0, params.modulus, lead + (num_per, 2, 1,
                                                  params.poly_len), dtype=U64)
    half = num_per // 2
    for s in tuple(zero_a) + tuple(zero_both):
        cts[..., s, :, :, :] = 0
    for s in tuple(zero_b) + tuple(zero_both):
        cts[..., half + s, :, :, :] = 0
    return cts


@pytest.mark.parametrize("per_query", [False, True], ids=["shared", "per-query"])
def test_fold_matches_jax(per_query):
    """fold_ciphertexts over a batch (NQ, IT, num_per, 2, 1, n), with one key
    set for all entries or one per query (leading key dims), including slots
    whose a, b or both halves are exactly zero."""
    params = get_no_expansion_testing_params()
    pj = J(params)
    nq, it = 2, 2
    vf = folding_keys(params, [0x21, 0x31] if per_query else [0x21])
    if not per_query:
        vf = vf[0]
    g_ntt = poly.to_ntt(pj, poly.build_gadget(pj, 2, 2 * params.t_gsw))
    rng = np.random.default_rng(41)
    cts = planted_cts(rng, params, (nq, it), zero_a=(0,), zero_b=(1,),
                      zero_both=(2,))
    cts[1, 1] = 0                      # an entry with nothing in it
    cts[0, 1, 1:] = 0                  # and one with a single item

    def fold_jax(h, l, v):
        vn = sj.get_v_folding_neg(pj, v, g_ntt.astype(np.uint32))
        return sj.fold_ciphertexts(pj, h, l, v, vn)

    fh, fl = jax.jit(fold_jax)(*(jnp.asarray(x) for x in _split_pair_np(cts)),
                               jnp.asarray(vf.astype(np.uint32)))
    want = _join_pair_np(np.asarray(fh), np.asarray(fl))
    vf_t = t32(vf)
    vn_t = st.get_v_folding_neg(params, vf_t, t32(g_ntt))
    got = st.fold_ciphertexts(params, torch.from_numpy(cts.astype(np.int64)),
                              vf_t, vn_t).numpy().astype(U64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 1], cts[0, 1, 0])   # verbatim
    assert not got[1, 1].any()


def test_fold_round_plain_equals_composed_round():
    """One round of fold_round_plain = the public fold's first round: the
    zero slots return the other half verbatim, the rest the GSW product."""
    params = get_no_expansion_testing_params()
    pj = J(params)
    vf = t32(folding_keys(params, [0x21])[0])
    g_ntt = poly.to_ntt(pj, poly.build_gadget(pj, 2, 2 * params.t_gsw))
    vn = st.get_v_folding_neg(params, vf, t32(g_ntt))
    rng = np.random.default_rng(42)
    cts = torch.from_numpy(planted_cts(
        rng, params, (3,), zero_a=(0,), zero_b=(1,)).astype(np.int64))
    key = params.db_dim_2 - 1
    out = st.fold_round_plain(params, cts, vn[key], vf[key])
    half = cts.shape[1] // 2
    assert out.shape == (3, half, 2, 1, params.poly_len)
    assert torch.equal(out[:, 0], cts[:, half])       # a == 0 -> b
    assert torch.equal(out[:, 1], cts[:, 1])          # b == 0 -> a
    # the remaining rounds on this output give the whole fold
    rest = out
    for k in range(key - 1, -1, -1):
        rest = st.fold_round_plain(params, rest, vn[k], vf[k])
    assert torch.equal(rest[:, 0], st.fold_ciphertexts(params, cts, vf, vn))
    with pytest.raises(ValueError):
        st.fold_ciphertexts(params, cts, vf[None], vn[None])   # 1 key, 3 cts


@pytest.mark.parametrize("params", [FAST, V1_TINY], ids=["v0", "v1"])
def test_pack_queries_matches_jax(params):
    """pack for two queries x instances in one call (what kernel G launches
    once), each query with its own client's keys, against sj.pack per
    (query, instance); the raw form equals from_ntt of the NTT form."""
    pj = J(params)
    nq, inst = 2, params.instances
    rng = np.random.default_rng(43)
    v_ct = rng.integers(0, params.modulus, (nq, inst, params.n * params.n, 2,
                                            1, params.poly_len), dtype=U64)
    v_ct[1, 0, 1] = 0                       # an all-zero scalar ct
    pps = [client_keys(params, seed)[1] for seed in (0x41, 0x51)]
    pack_jax = jax.jit(lambda h, l, k: sj.pack(pj, h, l, k))
    want = np.stack([np.stack([np.asarray(pack_jax(
        *(jnp.asarray(x) for x in _split_pair_np(v_ct[i, j])),
        [jnp.asarray(m.astype(np.uint32)) for m in pps[i].v_packing]))
        for j in range(inst)]) for i in range(nq)])
    keys_t = [[t32(m) for m in pp.v_packing] for pp in pps]
    v_ct_t = torch.from_numpy(v_ct.astype(np.int64))
    got = st.pack_queries(params, v_ct_t, keys_t)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    raw = st.pack_queries(params, v_ct_t, keys_t, raw=True)
    assert torch.equal(raw, st.from_ntt(params, got))
    # keyed (w, w') pairs are taken too, and one (query, instance) alone
    one = st.pack(params, v_ct_t[1, 0], [(k, k) for k in keys_t[1]])
    assert torch.equal(one, got[1, 0])


@pytest.mark.parametrize("params", [FAST, P16], ids=["p256", "p16"])
def test_ingest_matches_jax(params):
    """ingest_items_device (plain) against the JAX program, and ingest_into
    against db_limbs of the same residues, for one byte a coefficient and
    for 4-bit fields."""
    rng = np.random.default_rng(44)
    chunks = params.instances * params.n * params.n
    raw = rng.integers(0, 256, (5, chunks, params.bytes_per_chunk()),
                       dtype=np.uint8)
    raw[3] = 0
    want = np.asarray(jax.jit(lambda rb: ingest_jax.ingest_items_device(
        J(params), rb))(jnp.asarray(raw)))
    raw_t = torch.from_numpy(raw)
    got = ingest_t.ingest_items_device(params, raw_t)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert torch.equal(got, ingest_t.ingest_plain(params, raw_t))

    # in-place write of items at distinct (bin, column) pairs
    num_per, dim0 = 1 << params.db_dim_2, 1 << params.db_dim_1
    bins = np.array([0, 1, num_per - 1, 2, 1])
    cols = np.array([0, 3, dim0 - 1, 1, 0])
    db = torch.zeros(st.db_shape(params), dtype=torch.int8)
    ingest_t.ingest_into(params, db, bins, cols, raw_t)
    vals = np.zeros((params.crt_count, params.poly_len, params.instances,
                     params.n * params.n, num_per, dim0), dtype=np.int64)
    for k in range(5):
        vals[:, :, :, :, bins[k], cols[k]] = want[k].astype(np.int64).reshape(
            params.instances, params.n * params.n, params.crt_count,
            params.poly_len).transpose(2, 3, 0, 1)
    assert torch.equal(db, st.db_limbs(params, torch.from_numpy(vals)))
    with pytest.raises(ValueError):
        ingest_t.ingest_items_device(params, raw_t[:, :, :-1])


def test_compact_slots_state_roundtrip():
    """CompactSlots.to_state / load_state (what a compact checkpoint
    carries) against the JAX package's class on the same assignments."""
    params = FAST
    a = ingest_t.CompactSlots(params)
    b = ingest_jax.CompactSlots(J(params))
    idxs = [0, 4, 8, 5, 1, 12, 16, 20, 24, 28, 32, 36]
    for slots in (a, b):
        slots.cap_bin = slots.assign(idxs)[3]
    assert a.to_state() == b.to_state()
    c = ingest_t.CompactSlots(params)
    c.load_state(json.loads(json.dumps(b.to_state())))
    assert c.slot_of == a.slot_of and c.cap_bin == a.cap_bin
    assert np.array_equal(c.bin_count, a.bin_count)
    for got, want in zip(c.assign([40, 5]), b.assign([40, 5])):
        assert np.array_equal(got, want)
