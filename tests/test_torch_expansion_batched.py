"""The batched expansion's schedules, a CPU model of kernel E's blocks
(csrc/expansion.cu) and the engine's batched reads against the numpy oracle
on the CPU.

Integer arithmetic: every comparison is exact (tolerance 0). Kernel E runs
only on the card (tests/test_torch_kernels_gpu.py); here its per-block work
list, its Shoup arithmetic, its NTT-domain automorphism of row 1 and its
split of an entry's digits over a cluster are replayed in numpy against
``expansion_round_plain``, and the schedules against the reference's masks
and the sparse plan. The batched expansion against the JAX engine's
(spiral_jax.coefficient_expansion / _sparse) sits beside the expansion
tests that already trace those programs, one traced engine a module:
tests/test_torch_ops.py (dense) and tests/test_torch_compact.py (sparse).
"""

import json

import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j, server_host
from sdk_tpu.client import Client as ClientJ
from sdk_tpu.client import PublicParameters as PublicParametersJ
from sdk_tpu.client import Query as QueryJ
from sdk_tpu.ops.server_jax import pp_to_device
from sdk_tpu.rng import ChaCha20Rng as RngJ
from sdk_tpu_torch import convert
from sdk_tpu_torch.client import Query
from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.ops.server import SpiralServerTorch, serving_working_set_bytes
from sdk_tpu_torch.params import params_from_json, params_to_json_obj
from sdk_tpu_torch.params_store import get_params_from_store

torch.set_num_threads(1)
U64 = np.uint64
M32 = (1 << 32) - 1
# tests/test_torch_ops.py:39: four expansion rounds, stop_round 2
EXP_TINY = params_from_json(
    '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 3,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')
RIGHT = EXP_TINY.t_gsw * EXP_TINY.db_dim_2
# two populated sets, one with column 0 and the last
POPS = ({1, 2, 6}, {0, 3, 7})
NQ = 3


def J(params):
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


@pytest.fixture(scope="module")
def batch():
    """Three sessions with their own keys and one query each: the JAX
    package's objects, the port's key dicts and queries."""
    pj = J(EXP_TINY)
    out = {"pj": pj, "clients": [], "pp": [], "pp_t": [], "q": [], "q_t": []}
    for s in range(NQ):
        c = ClientJ(pj)
        pp = c.generate_keys_from_seed(bytes([0x21 + s]) * 32,
                                       noise_rng=RngJ(bytes([0x31 + s]) * 32),
                                       pp_seed=bytes([0x41 + s]) * 32)
        q = c.generate_query(2 * s + 1, noise_rng=RngJ(bytes([0x51 + s]) * 32),
                             query_seed=bytes([0x61 + s]) * 32)
        out["clients"].append(c)
        out["pp"].append(pp)
        out["pp_t"].append(convert.pp_from_jax(pp_to_device(pj, pp)))
        out["q"].append(q)
        out["q_t"].append(Query.deserialize(EXP_TINY, q.serialize(pj)))
    return out


def ct0s(batch) -> torch.Tensor:
    ct = np.stack([q.ct for q in batch["q_t"]]).astype(np.int64)
    return sj.to_ntt(EXP_TINY, torch.from_numpy(ct))


def schedule_of(pop):
    if pop is None:
        return sj.dense_schedule(EXP_TINY, RIGHT)
    return sj.SparseExpansionPlan(EXP_TINY, pop, RIGHT).schedule


# ---------------------------------------------------------------------------
# the schedule tables

def test_dense_schedule_at_the_1gib_bucket():
    """Parents, negations and sides of every round at
    get_params_from_store(15, 32768): 1,128 updated entries a query (2 + 4
    + ... + 64 + 106 + 128 + 256 + 512), the right key at round 0 and for
    odd entries, 42 odd entries updated at the stop round (6), none after;
    the updated entries first in every work list."""
    params = get_params_from_store(15, 32768)
    right = params.t_gsw * params.db_dim_2
    rounds = sj.dense_schedule(params, right)
    assert [rd.n_update for rd in rounds] == [2, 4, 8, 16, 32, 64, 106, 128,
                                              256, 512]
    for r, rd in enumerate(rounds):
        items = rd.items.numpy()
        out, parent, neg, side = items.T
        assert sorted(out) == list(range(2 << r)) and rd.n_in == 1 << r
        assert (parent == out % (1 << r)).all() and (neg == (out >> r)).all()
        assert (side[:rd.n_update] != sj.CARRIED).all()
        assert (side[rd.n_update:] == sj.CARRIED).all()
        odd = out % 2 == 1
        if r == 0:
            assert (side == sj.RIGHT).all()
            continue
        assert (side[~odd] == sj.LEFT).all()
        upd_odd = odd & (side == sj.RIGHT)
        want = (out // 2 < right) if r == params.stop_round() else (
            r < params.stop_round())
        assert (upd_odd == (odd & want)).all(), r
    assert sum(rd.n_left for rd in rounds) == sum(1 << r for r in range(1, 10))
    assert sum(rd.n_right for rd in rounds) == 2 + 62 + right


@pytest.mark.parametrize("pop", POPS, ids=["1,2,6", "0,3,7"])
def test_sparse_schedule_equals_the_plan(pop):
    """Each work list row is the plan's parent_pos / neg_mask at its output
    entry, and its side the group src_sel takes it from."""
    splan = sj.SparseExpansionPlan(EXP_TINY, pop, RIGHT)
    for rd, rnd in zip(splan.rounds, splan.schedule):
        items = rnd.items.numpy()
        order = np.argsort(items[:, 0])
        out, parent, neg, side = items[order].T
        assert (out == np.arange(len(out))).all()
        assert (parent == rd["parent_pos"].numpy()).all()
        assert (neg == rd["neg_mask"].numpy()).all()
        src = rd["src_sel"].numpy()
        n_ev, n_od = rd["even_sel"].numel(), rd["odd_sel"].numel()
        want = np.where(src < n_ev, sj.LEFT,
                        np.where(src < n_ev + n_od, sj.RIGHT, sj.CARRIED))
        assert (side == want).all()
        assert sorted(np.flatnonzero(side == sj.LEFT).tolist()) == \
            rd["even_sel"].tolist()
        assert sorted(np.flatnonzero(side == sj.RIGHT).tolist()) == \
            rd["odd_sel"].tolist()


def test_ntt_automorphism_is_a_slot_gather():
    """Row 1's automorphism in kernel E: NTT(tau_r(a)) equals NTT(a)
    gathered through ntt_automorph_perms for every round, negated zeros
    (Q, not 0) included, at two parameter sets."""
    rng = np.random.default_rng(3)
    for params in (EXP_TINY, get_params_from_store(15, 32768)):
        perms = sj.ntt_automorph_perms(params)
        raw = torch.from_numpy(rng.integers(0, params.modulus,
                                            (2, params.poly_len)))
        raw[0, :40] = 0
        x = sj.to_ntt(params, raw)
        for r in range(params.poly_len_log2):
            perm, neg = sj.automorph_tables(params, (params.poly_len >> r) + 1)
            auto = sj.automorph_pair(params, raw, torch.from_numpy(perm),
                                     torch.from_numpy(neg))
            want = sj.to_ntt(params, auto)
            got = torch.stack([x[:, c, torch.from_numpy(perms[r, c]).long()]
                               for c in range(params.crt_count)], dim=1)
            assert torch.equal(got, want), r


# ---------------------------------------------------------------------------
# a CPU model of kernel E's blocks

def _shoup(w, wp, y, q):
    """The kernel's w * y - mulhi(y, w') * q in wrapping 32-bit arithmetic."""
    w, wp, y = (np.asarray(a, dtype=U64) for a in (w, wp, y))
    return (w * y - ((y * wp) >> U64(32)) * U64(q)) & U64(M32)


def emulate_round(params, plan, r, cts, rnd, keys, cluster):
    """Replay kernel E on one round: block b = (item b // cluster // NQ,
    query b // cluster % NQ, rank b % cluster) computes as the kernel does
    (Shoup negation, carried copy, row 0's inverse transform and composed
    automorphism, its rank's digits forward-transformed and multiplied into
    32-bit sums below 2q, block 0 adding the partials, row 1's automorphism
    gathered in the NTT domain) and stores its entry; every output word must
    be stored exactly once. cts: int32 (NQ, n_in, 2, 1, 2, n)."""
    nq, n = cts.shape[0], params.poly_len
    q0, q1 = params.moduli
    items = rnd.items.numpy()
    x = cts.numpy().view(np.uint32).astype(U64).reshape(nq, -1, 2, 2, n)
    out = np.zeros((nq, rnd.n_out, 2, 2, n), dtype=U64)
    stored = np.zeros((nq, rnd.n_out), dtype=int)
    neg1 = plan.neg1[r].numpy().view(np.uint32).astype(U64)
    neg1s = plan.neg1_shoup[r].numpy().view(np.uint32).astype(U64)
    perm = plan.perm_all[r].numpy()
    negm = plan.negm_all[r].numpy().astype(bool)
    pn = plan.perm_ntt[r].numpy()
    qs = np.array(params.moduli, dtype=U64).reshape(2, 1)
    table = {}                          # the (query, side) key pointers
    for side in (sj.LEFT, sj.RIGHT):
        if r < min(len(k) for k in (keys.left if side == sj.LEFT
                                    else keys.right)):
            for i, (w, ws) in enumerate(keys.round_keys(r, side)):
                table[i, side] = (w.numpy().view(np.uint32).astype(U64),
                                  ws.numpy().view(np.uint32).astype(U64))
    for blk in range(len(items) * nq):
        o, p, ng, side = items[blk // nq]
        qi = blk % nq
        b = x[qi, p].copy()                            # (row, channel, n)
        if ng:
            b = np.stack([_shoup(neg1[c], neg1s[c], x[qi, p, :, c],
                                 params.moduli[c]) for c in range(2)], axis=1)
            assert (b < 2 * qs).all()
            b = np.where(b >= qs, b - qs, b)
        if side == sj.CARRIED:
            out[qi, o] = b
            stored[qi, o] += 1
            continue
        x0 = sj.ntt_inverse_plain(params, torch.from_numpy(
            b[0].astype(np.int64).astype(np.int32))).numpy().astype(U64)
        d = (x0[1] + U64(q1) - x0[0] % U64(q1)) % U64(q1) \
            * U64(params.inv_q0_mod_q1) % U64(q1)
        val = (x0[0] + U64(q0) * d)[perm]                # < Q < 2^57
        auto0 = np.where(negm, U64(params.modulus) - val, val)
        t_exp = (params.t_exp_left, params.t_exp_right)[side]
        bits = sj._get_bits_per(params, t_exp)
        w, ws = table[qi, side]
        parts = []
        for ks in sj.expansion_digit_split(t_exp, cluster):
            acc = np.zeros((2, 2, n), dtype=U64)
            for k in ks:
                off = k * bits
                dig = (auto0 >> U64(off)) & U64((1 << min(bits, 32)) - 1) \
                    if off < 64 else np.zeros(n, dtype=U64)
                f = sj.ntt_forward_plain(params, torch.from_numpy(
                    np.stack([dig, dig]).astype(np.uint32).view(np.int32))
                ).numpy().astype(U64)
                for row in range(2):
                    for c in range(2):
                        t = acc[row, c] + _shoup(w[row, k, c], ws[row, k, c],
                                                 f[c], params.moduli[c])
                        acc[row, c] = np.where(t >= 2 * qs[c], t - 2 * qs[c], t)
                assert (acc < 2 * qs).all()
            parts.append(acc)
        acc = sum(parts) % qs                          # block 0's sum
        res = (b + acc) % qs
        gathered = np.stack([b[1, c, pn[c]] for c in range(2)])
        res[1] = (res[1] + gathered) % qs
        out[qi, o] = res
        stored[qi, o] += 1
    assert (stored == 1).all()
    return torch.from_numpy(out.astype(np.uint32).view(np.int32)).reshape(
        nq, rnd.n_out, 2, 1, 2, n)


def _keys(batch):
    return sj.ExpansionKeys(EXP_TINY, batch["pp_t"])


@pytest.mark.parametrize("pop", [None, POPS[1]], ids=["dense", "sparse"])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_emulated_kernel_matches_plain(batch, pop, cluster):
    """Every round of the dense and the sparse schedule at NQ = 3 with three
    key sets, every entry split over 1, 2 and 4 blocks, with parents whose
    coefficients are zero, so that negated zeros (Q) reach the digits: the
    model of kernel E equals expansion_round_plain."""
    plan = sj.ExpansionPlan(EXP_TINY, "cpu")
    keys = _keys(batch)
    cts = ct0s(batch)[:, None]
    raw = torch.from_numpy(np.random.default_rng(5).integers(
        0, EXP_TINY.modulus, (2, 1, EXP_TINY.poly_len)))
    raw[:, :, ::7] = 0
    for r, rnd in enumerate(schedule_of(pop)):
        cts = cts.clone()
        cts[0, 0, 0] = 0              # row 0 raw zero: negated to Q
        cts[1, -1] = sj.to_ntt(EXP_TINY, raw)
        want = sj.expansion_round_plain(EXP_TINY, plan, r, cts, rnd, keys)
        got = emulate_round(EXP_TINY, plan, r, cts, rnd, keys, cluster)
        assert torch.equal(got, want), r
        cts = want


def test_emulated_kernel_wide_digits():
    """t_exp 1 on the left (57-bit digits, reduced before the transform)
    and 3 on the right, random keys for two queries: the model of kernel E
    equals expansion_round_plain at every dense round, clusters 1 and 2."""
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    params = params_from_json(
        '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 3,'
        ' "t_conv": 3, "t_exp_left": 1, "t_exp_right": 3, "instances": 1,'
        ' "version": 1}')
    rng = np.random.default_rng(8)

    def keyed(t):
        m = np.stack([rng.integers(0, q, (2, t, params.poly_len))
                      for q in params.moduli], axis=-2).astype(U64)
        return (u32_bits(m, "cpu"), u32_bits(shoup_companion_arr(params, m),
                                             "cpu"))

    sets = [{"v_exp_left": [keyed(1) for _ in range(params.g())],
             "v_exp_right": [keyed(3) for _ in range(params.g())]}
            for _ in range(2)]
    keys = sj.ExpansionKeys(params, sets)
    plan = sj.ExpansionPlan(params, "cpu")
    cts = torch.from_numpy(np.stack(
        [rng.integers(0, q, (2, 1, 2, 1, params.poly_len))
         for q in params.moduli], axis=-2).astype(np.int32))
    for r, rnd in enumerate(sj.dense_schedule(params, RIGHT)):
        want = sj.expansion_round_plain(params, plan, r, cts, rnd, keys)
        for cluster in (1, 2):
            got = emulate_round(params, plan, r, cts, rnd, keys, cluster)
            assert torch.equal(got, want), (r, cluster)
        cts = want


def test_expansion_tiling_defaults():
    """One block an entry from 256 updated entries of a batch up, clusters
    of 2 from 64 and of 4 below, never more blocks than digits; only
    clusters of 1, 2 and 4."""
    assert sj.expansion_tiling(512, 5).cluster == 1
    assert sj.expansion_tiling(255, 5).cluster == 2
    assert sj.expansion_tiling(64, 5).cluster == 2
    assert sj.expansion_tiling(2, 5).cluster == 4
    assert sj.expansion_tiling(2, 3).cluster == 2
    assert sj.expansion_tiling(2, 1).cluster == 1
    for c in (3, 8):
        with pytest.raises(ValueError):
            sj.expansion_tiling(2, 5, c)
    assert [list(s) for s in sj.expansion_digit_split(5, 4)] == [
        [0], [1], [2], [3, 4]]


def test_launch_refuses_cpu_tensors(batch):
    plan = sj.ExpansionPlan(EXP_TINY, "cpu")
    rnd = sj.dense_schedule(EXP_TINY, RIGHT)[0]
    with pytest.raises(ValueError):
        sj._expansion_launch(EXP_TINY, plan, 0, ct0s(batch)[:, None], rnd,
                             _keys(batch))


# ---------------------------------------------------------------------------
# whole responses

@pytest.mark.parametrize("pop", [None, POPS[0]], ids=["dense", "sparse"])
def test_batched_engine_matches_oracle(batch, pop):
    """The engine's single read and its batch of three (padded to four)
    answer with sdk_tpu.server_host.process_query's bytes; with a populated
    set the unpopulated first-dim rows of the DB are zero, as a bucket's
    are, and the engine expands sparsely."""
    pj = batch["pj"]
    _, db = server_host.generate_random_db_and_get_item(pj, 1)
    if pop is not None:
        drop = [j for j in range(1 << EXP_TINY.db_dim_1) if j not in pop]
        db[..., drop] = 0
    srv = SpiralServerTorch(EXP_TINY, "cpu")
    srv.set_db_host_tensor(db)
    srv.set_populated_dim0(pop)
    assert (srv._splan is None) == (pop is None)
    want = [server_host.process_query(
        pj, PublicParametersJ.deserialize(pj, pp.serialize(pj)),
        QueryJ.deserialize(pj, q.serialize(pj)), db)
        for pp, q in zip(batch["pp"], batch["q"])]
    assert srv.process_query(batch["pp_t"][0], batch["q_t"][0]) == want[0]
    got = srv.dispatch_queries_batched(list(zip(batch["pp_t"],
                                                batch["q_t"])))()
    assert got == want


def test_working_set_counts_the_batched_expansion():
    """serving_working_set_bytes grows with nq by at least the batched
    expansion's two round buffers, 2 * 2^g * 2 * crt * n * 4 bytes a query."""
    for params in (EXP_TINY, get_params_from_store(15, 32768)):
        two_buffers = 2 * (1 << params.g()) * 2 * params.crt_count \
            * params.poly_len * 4
        for nq in (1, 4, 15):
            grow = serving_working_set_bytes(params, nq + 1) \
                - serving_working_set_bytes(params, nq)
            assert grow >= two_buffers
