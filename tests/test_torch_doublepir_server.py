"""ChecklistServerTorch (plain versions, on the CPU) against
ChecklistServerJax and the host scheme: squished H1, A2^T, the client hint
and every answer matrix are equal word for word on the same DB, and recover
returns the planted bits through the port's client. Integer results: the
tolerance is 0."""

import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import params as params_j
from sdk_tpu.doublepir.server_jax import ChecklistServerJax
from sdk_tpu_torch.convert import checklist_from_jax
from sdk_tpu_torch.doublepir import scheme
from sdk_tpu_torch.doublepir.client import DoublePirClient
from sdk_tpu_torch.doublepir.database import Db
from sdk_tpu_torch.doublepir.params import Params
from sdk_tpu_torch.doublepir.serializer import serialize_state
from sdk_tpu_torch.doublepir.server_torch import ChecklistServerTorch

torch.set_num_threads(1)

# small checklist-style config: p=464 makes 1-bit entries byte-packed
# (packing=8, ne=x=1) exactly like the production deployment
CONFIG = "64,6.4,13,17,32,464"
PARAMS = Params.from_string(CONFIG)
NUM_ENTRIES = PARAMS.l * PARAMS.m * 8 - 5        # exercise the byte tail


def _bit_bytes():
    return np.random.default_rng(3).integers(
        0, 256, (NUM_ENTRIES + 7) // 8, dtype=np.uint16).astype(np.uint8)


def _shared(rng):
    """Small random shared matrices (same shapes scheme.init derives)."""
    return [rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
            for shape in ((PARAMS.m, PARAMS.n), (PARAMS.l, PARAMS.n))]


@pytest.fixture(scope="module")
def trio():
    """The host scheme, the JAX server and the port on one DB and one pair
    of shared matrices."""
    bit_bytes = _bit_bytes()
    shared = _shared(np.random.default_rng(4))
    host_db = Db.from_packed_bits(NUM_ENTRIES, PARAMS, bit_bytes)
    server_state, hint = scheme.setup(host_db, shared, PARAMS)
    srv_j = ChecklistServerJax(NUM_ENTRIES, params_j.Params.from_string(CONFIG),
                               bit_bytes)
    hint_j = srv_j.setup(shared)
    srv_t = ChecklistServerTorch(NUM_ENTRIES, PARAMS, bit_bytes, device="cpu")
    hint_t = srv_t.setup(shared)
    return dict(bit_bytes=bit_bytes, shared=shared, host_db=host_db,
                server_state=server_state, hint=hint, srv_j=srv_j,
                hint_j=hint_j, srv_t=srv_t, hint_t=hint_t)


def _queries(shared, info, targets, seed):
    rng = np.random.default_rng(seed)
    states, msgs = zip(*(scheme.query(t, shared, PARAMS, info, rng)
                         for t in targets))
    return list(states), list(msgs)


def test_setup_matches_jax_and_host(trio):
    t, j = trio["srv_t"], trio["srv_j"]
    np.testing.assert_array_equal(t.h1_sq, np.asarray(j.h1_sq))
    np.testing.assert_array_equal(t.h1_sq, trio["server_state"][0])
    np.testing.assert_array_equal(t.a_2_t, j.a_2_t)
    np.testing.assert_array_equal(t.a_2_t, trio["server_state"][1])
    np.testing.assert_array_equal(trio["hint_t"][0], trio["hint_j"][0])
    np.testing.assert_array_equal(trio["hint_t"][0], trio["hint"][0])
    np.testing.assert_array_equal(t.db.numpy(), np.asarray(j.db))
    np.testing.assert_array_equal(t.h1_lo.numpy(), np.asarray(j.h1_lo))
    np.testing.assert_array_equal(t.h1_hi.numpy(), np.asarray(j.h1_hi))


@pytest.mark.parametrize("nq", [1, 4, 8])
def test_answer_matches_jax_and_host_and_recovers(trio, nq):
    all_bits = np.unpackbits(trio["bit_bytes"], bitorder="little")[:NUM_ENTRIES]
    ones, zeros = np.flatnonzero(all_bits == 1), np.flatnonzero(all_bits == 0)
    targets = [int(x) for x in (ones[0], zeros[0], ones[-1], zeros[-1],
                                ones[7], zeros[9], ones[40], zeros[33])][:nq]
    info = trio["srv_t"].info
    states, queries = _queries(trio["shared"], info, targets, 7 + nq)
    got = trio["srv_t"].answer(queries)
    want_j = trio["srv_j"].answer(queries)
    want_h = scheme.answer(trio["host_db"], queries, trio["server_state"],
                           PARAMS)
    assert len(got) == len(want_j) == len(want_h) == 1 + 2 * nq
    for g, wj, wh in zip(got, want_j, want_h):
        np.testing.assert_array_equal(g, wj)
        np.testing.assert_array_equal(g, wh)
    # through the client's batch plan (one query per row batch): every
    # planned target decodes to its planted bit
    client = DoublePirClient(PARAMS, info, trio["shared"])
    client.hint = trio["hint_t"]
    qs, datas, plan = client.generate_query_batch(
        targets, np.random.default_rng(70 + nq))
    raw = serialize_state(trio["srv_t"].answer(qs))
    hit = 0
    for b, entry in enumerate(plan):
        if entry is not None:
            assert client.decode_response(raw, entry[0], b, datas[b]) \
                == int(all_bits[entry[0]])
            hit += 1
    assert hit >= 1


def test_rejects_non_checklist_config_and_mesh():
    params = Params(n=64, sigma=6.4, l=16, m=16, logq=32, p=991)
    # p=991 -> 9 bits packing, not the byte-element case
    with pytest.raises(ValueError):
        ChecklistServerTorch(100, params, np.zeros(13, dtype=np.uint8),
                             device="cpu")
    # a mesh is an ops.shard.Mesh (tests/test_torch_sharded.py serves one)
    with pytest.raises(TypeError, match="Mesh"):
        ChecklistServerTorch(NUM_ENTRIES, PARAMS, _bit_bytes(), mesh=object(),
                             device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ChecklistServerTorch(NUM_ENTRIES, PARAMS, _bit_bytes())


def test_setup_streamed_matches_scheme_and_jax(trio):
    """setup_streamed (chunked AES derive into a device buffer) must give
    the identical hint state as setup(scheme.init(...)): the production
    preprocess path with the REAL public matrices."""
    info = trio["srv_t"].info
    shared = scheme.init(info, PARAMS)
    host_db = Db.from_packed_bits(NUM_ENTRIES, PARAMS, trio["bit_bytes"])
    server_state, hint = scheme.setup(host_db, shared, PARAMS)
    srv = ChecklistServerTorch(NUM_ENTRIES, PARAMS, trio["bit_bytes"],
                               device="cpu")
    # tiny chunks force many updates + a ragged tail through the stream
    hint_t = srv.setup_streamed(chunk_bytes=PARAMS.n * 4 * 3)
    np.testing.assert_array_equal(srv.h1_sq, server_state[0])
    np.testing.assert_array_equal(hint_t[0], hint[0])
    srv_j = ChecklistServerJax(NUM_ENTRIES, params_j.Params.from_string(CONFIG),
                               trio["bit_bytes"])
    hint_j = srv_j.setup_streamed(chunk_bytes=PARAMS.n * 4 * 3)
    np.testing.assert_array_equal(hint_t[0], hint_j[0])
    # the streamed A2 residency: row-padded to SQUISH_DELTA, equal to the
    # host-derived A2, and serving identical answers
    got = srv._a2_pad_dev.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(srv_j._a2_pad_dev))
    np.testing.assert_array_equal(got[: shared[1].shape[0]], shared[1])
    assert not got[shared[1].shape[0]:].any()
    assert srv.a_2_t is None
    _, queries = _queries(shared, info, [11, 900], 9)
    for g, w in zip(srv.answer(queries), srv_j.answer(queries)):
        np.testing.assert_array_equal(g, w)


def test_install_hint_restores_serving_state(trio):
    srv = ChecklistServerTorch(NUM_ENTRIES, PARAMS, trio["bit_bytes"],
                               device="cpu")
    srv.install_hint(trio["srv_t"].h1_sq, trio["shared"][1])
    assert torch.equal(srv.h1_lo, trio["srv_t"].h1_lo)
    assert torch.equal(srv.h1_hi, trio["srv_t"].h1_hi)
    np.testing.assert_array_equal(srv.h1_sq, trio["srv_t"].h1_sq)
    _, queries = _queries(trio["shared"], srv.info, [5, 1000, 1700], 10)
    for g, w in zip(srv.answer(queries), trio["srv_j"].answer(queries)):
        np.testing.assert_array_equal(g, w)


def test_answers_from_the_jax_servers_own_state(trio):
    """checklist_from_jax -> install_state: the port answers from the JAX
    server's DB, digit planes and A2 without any setup of its own."""
    srv = ChecklistServerTorch(NUM_ENTRIES, PARAMS, np.zeros(1, np.uint8),
                               device="cpu")
    srv.install_state(checklist_from_jax(trio["srv_j"]))
    np.testing.assert_array_equal(srv.h1_sq, np.asarray(trio["srv_j"].h1_sq))
    _, queries = _queries(trio["shared"], srv.info, [0, 600, 1200, 1762], 11)
    for g, w in zip(srv.answer(queries), trio["srv_j"].answer(queries)):
        np.testing.assert_array_equal(g, w)
    bad = checklist_from_jax(trio["srv_j"])
    bad["h1_lo"] = bad["h1_lo"][:, :-1]
    with pytest.raises(ValueError, match="h1_lo"):
        srv.install_state(bad)


def test_db_dev_is_adopted(trio):
    db = trio["srv_t"].db.clone()
    srv = ChecklistServerTorch(NUM_ENTRIES, PARAMS, None, db_dev=db,
                               device="cpu")
    np.testing.assert_array_equal(srv.setup(trio["shared"])[0],
                                  trio["hint"][0])
    with pytest.raises(ValueError):
        ChecklistServerTorch(NUM_ENTRIES, PARAMS, None, db_dev=db[:-1],
                             device="cpu")


def test_answer_refuses_short_second_level_queries(trio):
    _, queries = _queries(trio["shared"], trio["srv_t"].info, [3], 12)
    queries[0][1] = queries[0][1][:-1]
    with pytest.raises(ValueError):
        trio["srv_t"].answer(queries)
