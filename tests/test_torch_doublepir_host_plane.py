"""The port's copy of DoublePIR's numpy host plane against the JAX package's
(sdk_tpu.doublepir.* and sdk_tpu.clients.bloom): the same inputs, made from
a numpy seed, give identical outputs. Integer results: the tolerance is 0."""

import numpy as np
import pytest

from sdk_tpu.clients import bloom as bloom_j
from sdk_tpu.doublepir import (client as client_j, database as database_j,
                               matrix as matrix_j, params as params_j,
                               scheme as scheme_j, serializer as serializer_j,
                               server as server_j)
from sdk_tpu_torch.clients import bloom as bloom_t
from sdk_tpu_torch.doublepir import (client as client_t,
                                     database as database_t,
                                     matrix as matrix_t, params as params_t,
                                     scheme as scheme_t,
                                     serializer as serializer_t,
                                     server as server_t)

U32 = np.uint32
CHECKLIST = "64,6.4,13,17,32,464"


def u32(rng, shape, bits=32):
    return rng.integers(0, 1 << bits, shape, dtype=np.uint64).astype(U32)


@pytest.mark.parametrize("num_entries, bits", [(1 << 10, 1), (1 << 14, 1),
                                               (1 << 16, 1), (1 << 12, 8),
                                               (300, 40)])
def test_pick_params_and_dbinfo_identical(num_entries, bits):
    pt = params_t.pick_params(num_entries, bits, lower_bound_m=1)
    pj = params_j.pick_params(num_entries, bits, lower_bound_m=1)
    assert pt.to_string() == pj.to_string()
    assert params_t.Params.from_string(pt.to_string()) == pt
    assert (pt.delta(), pt.ext_delta()) == (pj.delta(), pj.ext_delta())
    it = database_t.DbInfo.new(num_entries, bits, pt)
    ij = database_j.DbInfo.new(num_entries, bits, pj)
    assert it.to_string() == ij.to_string()
    assert serializer_t.serialize_dbinfo(it) == serializer_j.serialize_dbinfo(ij)


def test_production_checklist_params():
    s = "1024,6.4,92681,92683,32,464"
    pt, pj = params_t.Params.from_string(s), params_j.Params.from_string(s)
    assert pt.to_string() == pj.to_string() == s
    it = database_t.DbInfo.new(1 << 36, 1, pt)
    assert it.to_string() == database_j.DbInfo.new(1 << 36, 1, pj).to_string()
    assert (it.packing, it.ne, it.x) == (8, 1, 1)


def test_aes_derivation_goldens_and_ranges():
    """Golden bytes from the reference (derivation.rs:72-88), and any range
    of the keystream equal to the JAX package's."""
    for key, first, last in zip(matrix_t.SEEDS_SHORT, (247, 132), (63, 254)):
        assert matrix_t.derive_aes_bytes_range(key, 0, 1)[0] == first
        assert matrix_t.derive_aes_bytes_range(key, 258 * 65536, 1)[0] == last
    assert matrix_t.derive_aes_bytes(matrix_t.SEEDS_SHORT[0], 17)[16] == 196
    assert matrix_t.SEEDS_SHORT == matrix_j.SEEDS_SHORT
    for start, n in ((0, 100), (65530, 20), (3 * 65536 - 1, 65538)):
        assert matrix_t.derive_aes_bytes_range(matrix_t.SEEDS_SHORT[1], start, n) \
            == matrix_j.derive_aes_bytes_range(matrix_j.SEEDS_SHORT[1], start, n)
    np.testing.assert_array_equal(
        matrix_t.derive_from_seed_rows(17, 6, 4099, matrix_t.SEEDS_SHORT[0]),
        matrix_j.derive_from_seed(23, 4099, matrix_j.SEEDS_SHORT[0])[17:23])


@pytest.mark.parametrize("fn", ["squish", "unsquish", "expand", "contract",
                                "transpose_expand_concat_cols_squish",
                                "matmul_u32", "mat_mul_vec_packed",
                                "mat_mul_transposed_packed"])
def test_matrix_transforms_identical(fn):
    rng = np.random.default_rng(31)
    args = {
        "squish": (u32(rng, (10, 35), 10),),
        "unsquish": (u32(rng, (10, 12), 30), 35),
        "expand": (u32(rng, (8, 35)), 464, 4),
        "contract": (u32(rng, (32, 35)), 464, 4),
        "transpose_expand_concat_cols_squish": (u32(rng, (12, 3)), 97, 5, 2),
        "matmul_u32": (u32(rng, (37, 501)), u32(rng, (501, 5))),
        "mat_mul_vec_packed": (u32(rng, (16, 7), 30), u32(rng, (21, 2))),
        "mat_mul_transposed_packed": (u32(rng, (16, 7), 30),
                                      u32(rng, (5, 21))),
    }[fn]
    np.testing.assert_array_equal(getattr(matrix_t, fn)(*args),
                                  getattr(matrix_j, fn)(*args))


def test_serializer_bytes_identical_and_round_trip():
    rng = np.random.default_rng(32)
    states = [[u32(rng, (3, 4)), u32(rng, (1, 7))], [u32(rng, (5, 1))]]
    raw = serializer_t.serialize_states(states)
    assert raw == serializer_j.serialize_states(states)
    for got, want in zip(serializer_t.deserialize_states(raw), states):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    one = serializer_t.serialize_state(states[0])
    assert one == serializer_j.serialize_state(states[0])
    assert serializer_t.deserialize_state(one)[1] == len(one)


def matrices(x):
    """Every array of a nested list/tuple of arrays, in order."""
    if isinstance(x, (list, tuple)):
        for part in x:
            yield from matrices(part)
    else:
        yield np.asarray(x)


@pytest.mark.parametrize("config", [CHECKLIST, "64,6.4,16,16,32,991"])
def test_db_setup_query_answer_recover_identical(config):
    """The whole host scheme under one seed: DB build, setup, query, answer
    and recover give the JAX package's matrices and values."""
    pt, pj = (m.Params.from_string(config) for m in (params_t, params_j))
    num_entries = 1500
    rng = np.random.default_rng(33)
    bit_bytes = rng.integers(0, 256, (num_entries + 7) // 8,
                             dtype=np.uint16).astype(np.uint8)
    a_1, a_2 = u32(rng, (pt.m, pt.n)), u32(rng, (pt.l, pt.n))
    out = []
    for db_m, scheme_m, p in ((database_t, scheme_t, pt),
                              (database_j, scheme_j, pj)):
        db = db_m.Db.from_packed_bits(num_entries, p, bit_bytes)
        raw = db.data.copy()
        state, hint = scheme_m.setup(db, [a_1, a_2], p)
        qrng = np.random.default_rng(34)
        sts, qs = zip(*(scheme_m.query(t, [a_1, a_2], p, db.info, qrng)
                        for t in (5, 1499)))
        ans = scheme_m.answer(db, list(qs), state, p)
        vals = [scheme_m.recover(t, b, hint, qs[b], ans, [a_1, a_2], sts[b],
                                 p, db.info) for b, t in enumerate((5, 1499))]
        out.append((raw, db.data, state, hint, sts, qs, ans, vals,
                    db.get_elem(5)))
    flat = [list(matrices(side[:7])) for side in out]
    assert len(flat[0]) == len(flat[1])
    for g, w in zip(*flat):
        np.testing.assert_array_equal(g, w)
    assert out[0][7:] == out[1][7:]
    bits_le = np.unpackbits(bit_bytes, bitorder="little")
    assert out[0][7] == [int(bits_le[5]), int(bits_le[1499])]


def test_from_entries_matches_from_packed_bits():
    p = params_t.Params.from_string(CHECKLIST)
    rng = np.random.default_rng(35)
    bits = rng.integers(0, 2, 1000)
    packed = np.packbits(bits.astype(np.uint8), bitorder="little")
    np.testing.assert_array_equal(
        database_t.Db.from_entries(1000, 1, p, bits.tolist()).data,
        database_t.Db.from_packed_bits(1000, p, packed).data)


def test_client_query_plan_and_bytes_identical():
    pt, pj = (m.Params.from_string(CHECKLIST) for m in (params_t, params_j))
    it = database_t.DbInfo.new(1500, 1, pt)
    ij = database_j.DbInfo.new(1500, 1, pj)
    ct = client_t.DoublePirClient(pt, it)
    cj = client_j.DoublePirClient(pj, ij)
    for a, b in zip(ct.shared_state, cj.shared_state):
        np.testing.assert_array_equal(a, b)
    idxs = [3, 700, 1400, 9]
    qt, dt, plan_t = ct.generate_query_batch(idxs, np.random.default_rng(36))
    qj, dj, plan_j = cj.generate_query_batch(idxs, np.random.default_rng(36))
    assert plan_t == plan_j and dt == dj
    assert serializer_t.serialize_states(qt) == serializer_j.serialize_states(qj)
    assert ct.generate_query(77, np.random.default_rng(37)) \
        == cj.generate_query(77, np.random.default_rng(37))


def test_host_server_files_identical(tmp_path):
    """DoublePirServer (host preprocessing + checkpoint files) writes the
    JAX package's bytes and answers alike after a restore."""
    entries = np.random.default_rng(38).integers(0, 2, 1 << 10).tolist()
    params = "64,6.4,16,16,32,991"
    answers = []
    for name, mod, pm in (("t", server_t, params_t), ("j", server_j, params_j)):
        srv = mod.DoublePirServer(1 << 10, 1, pm.Params.from_string(params))
        srv.load_data(entries)
        srv.save_to_files(str(tmp_path / name))
        back = mod.DoublePirServer(1 << 10, 1, pm.Params.from_string(params))
        back.restore_from_files(str(tmp_path / name))
        assert back.get_hint() == srv.get_hint()
        cs, q = scheme_t.query(9, srv.shared_state, srv.params, srv.db.info,
                               np.random.default_rng(39))
        answers.append(back.answer(serializer_t.serialize_states([q])))
        np.testing.assert_array_equal(srv.adjustments, mod.DoublePirServer
                                      .generate_adjustments(srv.params,
                                                            srv.shared_state))
    assert answers[0] == answers[1]
    for ext in ("hint", "state", "dbp", "dbinfo", "params", "txt"):
        assert (tmp_path / f"t.{ext}").read_bytes() \
            == (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("bits", [10, 20, 36])
def test_bloom_hash_identical(bits):
    for key in ("alpha", "", "pässword", "x" * 100):
        for i in range(8):
            assert bloom_t.bloom_hash(key, i, bits) \
                == bloom_j.bloom_hash(key, i, bits) < (1 << bits)
    f = bloom_t.BloomFilter.empty(8, 10)
    f.insert("alpha")
    assert f.lookup("alpha")
    assert bloom_j.BloomFilter.from_bytes(f.to_bytes()).lookup("alpha")
