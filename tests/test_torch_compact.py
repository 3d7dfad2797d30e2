"""The port's compact index (kernel I's plain version, slot flush, growth,
migration), its sparse query expansion (J) and the elementwise body of an
expansion round (E' plain) against the JAX package on the same
numpy-seeded inputs. Integer arithmetic: every comparison is exact.

The port's Params come from the port's own params module; the JAX side gets
the JAX package's Params of the same JSON.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu.client import Client as ClientJ
from sdk_tpu.kv import ingest as ingest_j
from sdk_tpu.ops import spiral_jax as sj
from sdk_tpu.ops.server_jax import (SpiralServerJax, _join_pair_np,
                                    _split_pair_np, pp_to_device)
from sdk_tpu.rng import ChaCha20Rng as RngJ
from sdk_tpu_torch import convert
from sdk_tpu_torch import params as params_t
from sdk_tpu_torch.client import Query
from sdk_tpu_torch.kv.ingest import DbUpdateBuffer, compact_to_dense
from sdk_tpu_torch.ops import spiral as st
from sdk_tpu_torch.ops.modops import reduce_channels
from sdk_tpu_torch.ops.server import SpiralServerTorch

torch.set_num_threads(1)
U64 = np.uint64
# tests/test_compact_db.py:23 (dim0 8, num_per 4)
TINY = ('{"direct_upload": 1, "n": 2, "nu_1": 3, "nu_2": 2, "p": 256,'
        ' "q2_bits": 20, "t_gsw": 4, "t_conv": 4, "t_exp_left": 8,'
        ' "t_exp_right": 8}')
# tests/test_torch_ops.py:34: four expansion rounds, stop_round 2
EXP_TINY = ('{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22,'
            ' "t_gsw": 3, "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5,'
            ' "instances": 1, "version": 1}')


def both(cfg: str):
    """(JAX Params, port Params) of one JSON config."""
    return params_j.params_from_json(cfg), params_t.params_from_json(cfg)


def rand_row(params, rng) -> bytes:
    n = params.instances * params.n * params.n * params.bytes_per_chunk()
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def query_cols(params, rng, R: int) -> np.ndarray:
    return np.stack([rng.integers(0, q, (params.poly_len,
                                         1 << params.db_dim_1, R))
                     for q in params.moduli]).astype(np.uint32)


def jax_compact(pj, rows: dict, buf=None, db=None):
    buf = buf or ingest_j.DbUpdateBuffer(pj)
    for i, d in rows.items():
        buf.upsert_raw(i, d)
    return buf, buf.flush(sj.compact_db_empty(pj, cap_bin=4) if db is None
                          else db)


def port_flush(pt, rows: dict, db, buf=None):
    buf = buf or DbUpdateBuffer(pt, "cpu")
    for i, d in rows.items():
        buf.upsert_raw(i, d)
    return buf, buf.flush(db)


def test_compact_scan_matches_jax_and_dense():
    """Kernel I's plain version on a JAX CompactDb carried across by
    convert.compact_from_jax equals the JAX compact scan (R = 2, 6) and the
    port's dense scan of the same rows (tests/test_compact_db.py:35, :81)."""
    pj, pt = both(TINY)
    rng = np.random.default_rng(1)
    rows = {i: rand_row(pj, rng) for i in (0, 5, 6, 9, 13, pj.num_items() - 1)}
    _, cj = jax_compact(pj, rows)
    compact = convert.compact_from_jax(pt, cj.planes, cj.idx_j)
    _, dense = port_flush(pt, rows, torch.zeros(st.db_shape(pt),
                                                dtype=torch.int8))
    for R in (2, 6):
        q = query_cols(pt, rng, R)
        want = np.asarray(sj.firstdim_multiply(pj, cj, jnp.asarray(q)))
        got = st.firstdim_multiply(pt, compact, torch.from_numpy(
            q.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
        assert torch.equal(got, st.firstdim_multiply(
            pt, dense, torch.from_numpy(q.astype(np.int32))))


def test_compact_flush_growth_migration_match_jax():
    """The port's slot flush (with growth from cap 4 and an overwrite) holds
    the JAX flush's index values, and compact_to_dense gives the JAX
    migration's dense index (tests/test_compact_db.py:35, :157, :174).
    Slot order may differ, so the indexes are compared after migration,
    which places every slot at its (bin, dim0) column."""
    pj, pt = both(TINY)
    rng = np.random.default_rng(7)
    first = {i: rand_row(pj, rng) for i in (1, 2, 6)}
    # bin 0 takes six items: cap 4 -> 8
    more = {i: rand_row(pj, rng) for i in (0, 4, 8, 12, 16, 20, 6)}
    bj, cj = jax_compact(pj, first)
    bt, ct = port_flush(pt, first, st.compact_db_empty(pt, "cpu", cap_bin=4))
    assert ct.cap_bin == 4
    slot6 = bt.slots.slot_of[6]
    _, cj = jax_compact(pj, more, bj, cj)
    _, ct = port_flush(pt, more, ct, bt)
    assert ct.cap_bin == 8 == cj.planes[0].shape[-1]
    assert bt.slots.slot_of[6] == slot6     # a re-upserted item keeps its slot
    want = convert.db_from_jax_planes(pt, ingest_j.compact_to_dense(pj, cj))
    got = compact_to_dense(pt, ct, bt.slots.bin_count)
    assert torch.equal(got, want)
    _, dense = port_flush(pt, {**first, **more},
                          torch.zeros(st.db_shape(pt), dtype=torch.int8))
    assert torch.equal(got, dense)
    q = torch.from_numpy(query_cols(pt, rng, 2).astype(np.int32))
    assert torch.equal(st.firstdim_multiply(pt, ct, q),
                       st.firstdim_multiply(pt, dense, q))


def test_expand_round_plain_matches_jax():
    """E' plain: CRT compose + automorph_pair + gadget_digits of row 0 +
    row 1 reduced per channel, equal to the JAX functions, zeros included
    (a negated zero is Q, whose digits are not zero)."""
    pj, pt = both(EXP_TINY)
    rng = np.random.default_rng(14)
    raw = rng.integers(0, pt.modulus, (3, 2, 1, pt.poly_len), dtype=U64)
    raw[0, :, :, :64] = 0
    raw[2] = 0
    x = reduce_channels(pt, torch.from_numpy(raw.astype(np.int64)))
    for r, t_exp in ((0, pt.t_exp_right), (2, pt.t_exp_left)):
        perm, neg = sj.automorph_tables(pj, (pj.poly_len >> r) + 1)

        def jax_fn(h, l):
            ah, al = sj.automorph_pair(pj, h, l, perm, neg)
            return ah, al, sj.gadget_digits(pj, ah[:, 0:1], al[:, 0:1],
                                            t_exp, 1)

        ah, al, dig = (np.asarray(v) for v in jax.jit(jax_fn)(
            *(jnp.asarray(v) for v in _split_pair_np(raw))))
        auto = _join_pair_np(ah, al)
        assert (auto == pt.modulus).any()
        out = st.expand_round_plain(
            pt, x, (torch.from_numpy(perm), torch.from_numpy(neg)), t_exp)
        digits = out[:3 * t_exp].reshape(3, t_exp, pt.crt_count, pt.poly_len)
        for c in range(pt.crt_count):
            np.testing.assert_array_equal(digits[:, :, c].numpy(),
                                          dig[:, :, 0].astype(np.int32))
        row1 = out[3 * t_exp:].numpy()
        for c, q in enumerate(pt.moduli):
            np.testing.assert_array_equal(row1[:, c],
                                          (auto[:, 1, 0] % U64(q)).astype(
                                              np.int32))


def _session(pj, pt, seed: int):
    c = ClientJ(pj)
    pp = c.generate_keys_from_seed(bytes([seed]) * 32,
                                   noise_rng=RngJ(bytes([seed + 1]) * 32),
                                   pp_seed=bytes([seed + 2]) * 32)
    return c, pp


# the populated set test_sparse_expansion_matches_jax_and_dense has always
# used, and one with column 0 and the last of the same JAX plan signature
# (one compiled sparse program for both)
POPS = ({1, 2, 6}, {0, 3, 7})


@pytest.fixture(scope="module")
def sparse_batch():
    """Three EXP_TINY sessions with their own keys and one query each (the
    first as test_sparse_expansion_matches_jax_and_dense has always made
    it), and the JAX engine's sparse expand_query of each under both
    populated sets: one traced JAX sparse expansion for the module."""
    pj, pt = both(EXP_TINY)
    sessions = [_session(pj, pt, seed) for seed in (0x11, 0x31, 0x41)]
    queries = [sessions[0][0].generate_query(5, noise_rng=RngJ(b"\x14" * 32),
                                             query_seed=b"\x15" * 32)]
    queries += [c.generate_query(2 * i + 1, noise_rng=RngJ(bytes([0x54 + i]) * 32),
                                 query_seed=bytes([0x64 + i]) * 32)
                for i, (c, _) in enumerate(sessions[1:])]
    srv_j = SpiralServerJax(pj)
    jax = {}
    for pop in POPS:
        srv_j.set_populated_dim0(pop)
        jax[frozenset(pop)] = [
            tuple(np.asarray(x).astype(np.int32)
                  for x in srv_j.expand_query(pp_to_device(pj, pp), q))
            for (_, pp), q in zip(sessions, queries)]
    return {"pp": [convert.pp_from_jax(pp_to_device(pj, pp))
                   for _, pp in sessions],
            "queries": [Query.deserialize(pt, q.serialize(pj))
                        for q in queries], "jax": jax}


def test_sparse_expansion_matches_jax_and_dense(sparse_batch):
    """The engine's sparse expand stage (the sparse schedule, the leaf
    scatter, regev_to_gsw on the odd leaves) equals the JAX engine's
    and the port's dense expansion on the populated columns
    (tests/test_sparse_expansion.py:43)."""
    pt = params_t.params_from_json(EXP_TINY)
    pop = POPS[0]
    q_jax, vf_jax = sparse_batch["jax"][frozenset(pop)][0]
    srv = SpiralServerTorch(pt, "cpu")
    pp_t, query = sparse_batch["pp"][0], sparse_batch["queries"][0]
    q_dense, vf_dense = srv.expand_query(pp_t, query)
    srv.set_populated_dim0(pop)
    assert srv._splan is not None
    q_sparse, vf_sparse = srv.expand_query(pp_t, query)
    np.testing.assert_array_equal(q_sparse.numpy(), q_jax)
    np.testing.assert_array_equal(vf_sparse.numpy(), vf_jax)
    assert torch.equal(vf_sparse, vf_dense)
    cols = sorted(pop)
    assert torch.equal(q_sparse[:, :, cols], q_dense[:, :, cols])
    assert not q_sparse[:, :, [j for j in range(8) if j not in pop]].any()


@pytest.mark.parametrize("pop", POPS, ids=["1,2,6", "0,3,7"])
def test_batched_sparse_expansion_matches_jax(sparse_batch, pop):
    """The batched sparse expansion at NQ = 3, each query with its own
    keys, under two populated sets (one with column 0): expand_batch's
    leaves over the sparse schedule's work lists equal each query's
    expansion alone (NQ = 1, its own keys) leaf for leaf and the JAX
    engine's (spiral_jax.coefficient_expansion_sparse) on every leaf a read
    uses; the engine's expand_queries, padded to four column pairs, equals
    the JAX engine's expand_query of each query and repeats query 0's
    columns."""
    pt = params_t.params_from_json(EXP_TINY)
    right = pt.t_gsw * pt.db_dim_2
    pps, queries = sparse_batch["pp"], sparse_batch["queries"]
    jax = sparse_batch["jax"][frozenset(pop)]
    srv = SpiralServerTorch(pt, "cpu")
    srv.set_populated_dim0(pop)
    splan = srv._splan
    ct0 = st.to_ntt(pt, torch.from_numpy(
        np.stack([q.ct for q in queries]).astype(np.int64)))
    leaves = st.expand_batch(pt, srv.plan, splan.schedule, ct0,
                             st.ExpansionKeys(pt, pps))
    for i, pp in enumerate(pps):
        assert torch.equal(leaves[i], st.expand_batch(
            pt, srv.plan, splan.schedule, ct0[i:i + 1],
            st.ExpansionKeys(pt, [pp]))[0])
        q_jax, vf_jax = jax[i]
        reg = leaves[i, splan.even_leaf_pos, :, 0].permute(2, 3, 0, 1)
        np.testing.assert_array_equal(reg.numpy(), q_jax[:, :, sorted(pop)])
        gsw = leaves[i, splan.odd_leaf_pos, :, 0].numpy()
        assert gsw.shape[0] == right
        np.testing.assert_array_equal(gsw, vf_jax[:, :, 1::2].transpose(
            0, 2, 1, 3, 4).reshape(gsw.shape))
    q_all, v_folding, v_neg = srv.expand_queries(pps, queries, 4)
    assert torch.equal(v_neg, st.get_v_folding_neg(
        srv.params, v_folding, srv.gadget_ntt))
    cols = q_all.reshape(q_all.shape[:3] + (4, 2))
    for i, (q_jax, vf_jax) in enumerate(jax):
        np.testing.assert_array_equal(cols[:, :, :, i].numpy(), q_jax)
        np.testing.assert_array_equal(v_folding[i].numpy(), vf_jax)
    assert torch.equal(cols[:, :, :, 3], cols[:, :, :, 0])


def test_sparse_plan_rejects_full_and_empty():
    """(tests/test_sparse_expansion.py:143, :128)"""
    pt = params_t.get_fast_expansion_testing_params()
    srv = SpiralServerTorch(pt, "cpu")
    srv.set_populated_dim0(set())
    assert srv._splan is None
    srv.set_populated_dim0(set(range(1 << pt.db_dim_1)))
    assert srv._splan is None
    srv.set_populated_dim0({1, 9})
    assert srv._splan is not None
    srv.set_populated_dim0(None)
    assert srv._splan is None
    with pytest.raises(ValueError):
        st.SparseExpansionPlan(pt, [], 0)
    # the compacted schedule does far less than the dense 2^(r+1) per round
    right = pt.t_gsw * pt.db_dim_2
    pop = {i >> pt.db_dim_2 for i in (5, 6, 7, 37, 100, 200)}
    splan = st.SparseExpansionPlan(pt, pop, right)
    dense = sum(2 ** (r + 1) for r in range(pt.g()))
    sparse = sum(rd["even_sel"].numel() + rd["odd_sel"].numel()
                 for rd in splan.rounds)
    assert sparse < dense / 2
