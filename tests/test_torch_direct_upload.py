"""Direct-upload reads of the port on the CPU (each request carries its
public params, scan columns and GSW keys; the server expands nothing;
sdk_tpu/params.py:259, tests/test_kv_service.py:123-155).

Responses of SpiralServerTorch and SpiralKvServerTorch on the compact, the
dense and a (dp=2, db=2) logical-mesh index, single and batched (3 queries,
padded to 4), equal the numpy oracle sdk_tpu.server_host.process_query byte
for byte and decode; so does a read at get_no_expansion_testing_params. The
engine's columns, folding keys and their negations equal the JAX engine's
query_to_device (a to_ntt jit) and get_v_folding_neg word for word. Inputs
are made from seeds; tolerance 0.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdk_tpu import client as client_j, params as params_j, poly as poly_j
from sdk_tpu import server_host
from sdk_tpu.arith import recenter_mod_arr
from sdk_tpu.ops import spiral_jax as sjj
from sdk_tpu.ops.server_jax import SpiralServerJax
from sdk_tpu_torch.client import Client, PublicParameters, Query
from sdk_tpu_torch.clients.api import API
from sdk_tpu_torch.clients.bucket_service import connect_local
from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.ops.server import SpiralServerTorch, pp_to_device
from sdk_tpu_torch.ops.shard import make_mesh
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  get_no_expansion_testing_params,
                                  params_from_json, params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

from test_torch_http import spawn, stop
from test_torch_lifecycle import oracle_db, rand_rows

torch.set_num_threads(1)
CFG = ('{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
       ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
       ' "t_exp_right": 8}')
TINY = params_from_json(CFG)
ITEMS = [2, 5, 17, 40, 63]          # fewer than 1/8 of 64: a compact index


def J(params):
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def direct_request(params, seed: int, idx: int):
    """A seeded client and its request for item idx: the serialized public
    params, then the query."""
    client = Client(params)
    setup = client.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32).serialize(params)
    q = client.generate_query(idx, noise_rng=ChaCha20Rng(bytes([seed + 3]) * 32),
                              query_seed=bytes([seed + 4]) * 32)
    return client, setup + q.serialize(params)


def oracle(params, db: np.ndarray, blob: bytes) -> bytes:
    pj = J(params)
    head = params.setup_bytes()
    return server_host.process_query(
        pj, client_j.PublicParameters.deserialize(pj, blob[:head]),
        client_j.Query.deserialize(pj, blob[head:]), db)


def parsed(params, blob: bytes):
    head = params.setup_bytes()
    return (PublicParameters.deserialize(params, blob[:head]),
            Query.deserialize(params, blob[head:]))


@pytest.fixture(scope="module")
def case():
    """Rows of ITEMS, three requests (items 5, 40, 63) and the oracle's
    responses over the dense DB of those rows."""
    rows = rand_rows(TINY, np.random.default_rng(41), ITEMS)
    made = [direct_request(TINY, 0x20 + 8 * k, idx)
            for k, idx in enumerate([5, 40, 63])]
    db = oracle_db(TINY, rows)
    want = [oracle(TINY, db, b) for _, b in made]
    return rows, made, want


@pytest.mark.parametrize("layout", ["compact", "dense", "mesh"])
def test_bucket_reads_match_oracle(case, layout):
    """A bucket on the CPU: a single read and a 3-query batch equal the
    oracle and decode; the bucket builds no sparse expansion plan."""
    rows, made, want = case
    mesh = (make_mesh(4, dp=2, devices=[torch.device("cpu")] * 4)
            if layout == "mesh" else None)
    srv = SpiralKvServerTorch(TINY, "cpu", mesh=mesh)
    if layout == "dense":
        srv.dense_migrate_fill = 0.0            # migrates at the first flush
    for i, data in rows.items():
        srv.update_item_raw(i, data)
    blobs = [b for _, b in made]
    assert srv.private_read_one(blobs[0]) == want[0]
    got = srv.dispatch_read_blobs(blobs)()
    assert got == want
    meta = srv.meta()
    assert meta["index_layout"] == ("compact" if layout == "compact"
                                    else "dense")
    assert meta["sparse_expansion"] is False and srv.engine._splan is None
    assert meta["pir_scheme"]["direct_upload"] == 1
    for (client, _), idx, resp in zip(made, [5, 40, 63], got):
        assert client.decode_response(resp)[:len(rows[idx])] == rows[idx]


def sparse_db(pj, idxs, seed: int):
    """A host DB tensor (server_host.build_db_tensor's layout) holding
    random plaintexts at the items ``idxs`` and zeros elsewhere (an absent
    item's residues are 0); returns ({item: its (instances * n, n, z) mod-p
    matrix}, the DB)."""
    rng = np.random.default_rng(seed)
    inst, trials, n = pj.instances, pj.n * pj.n, pj.poly_len
    npr = 1 << pj.db_dim_2
    db = np.zeros((inst, trials, n, pj.crt_count, npr, 1 << pj.db_dim_1),
                  dtype=np.uint64)
    items = {}
    for idx in idxs:
        plain = rng.integers(0, pj.pt_modulus, (inst, trials, n),
                             dtype=np.uint64)
        ntt = poly_j.to_ntt(pj, recenter_mod_arr(
            plain, pj.pt_modulus, pj.modulus).reshape(inst * trials, 1, n))
        db[..., idx % npr, idx // npr] = ntt.reshape(inst, trials, -1, n) \
            .transpose(0, 1, 3, 2)
        items[idx] = plain.reshape(inst * pj.n, pj.n, n)
    return items, db


def test_engine_read_at_no_expansion_testing_params():
    """SpiralServerTorch at get_no_expansion_testing_params (n = 5,
    p = 2^16) over a DB whose target's first-dim row is full (every fold
    round combines two present items) and a few other items present: the
    oracle's bytes, decoding to the item."""
    params = get_no_expansion_testing_params()
    npr = 1 << params.db_dim_2
    target = 11
    row = [target // npr * npr + k for k in range(npr)]
    client, blob = direct_request(params, 0x50, target)
    items, db = sparse_db(J(params), row + [3, 200, 511], 43)
    srv = SpiralServerTorch(params, "cpu")
    srv.set_db_host_tensor(db)
    got = srv.process_query(*parsed(params, blob))
    assert got == oracle(params, db, blob)
    want = poly_j.raw_to_bytes(J(params), items[target], 16,
                               params.modp_words_per_chunk())
    assert client.decode_response(got) == want


def test_query_to_device_matches_jax(case):
    """query_to_device's columns (queries at 2i + r, fillers copies of
    query 0's) and folding keys equal SpiralServerJax.query_to_device
    query by query; direct_query is its one-query case; the negations are
    (gadget - v) mod q_c, the JAX get_v_folding_neg's words, also on keys
    with zero and q_c - 1 words planted."""
    _, made, _ = case
    reqs = [parsed(TINY, b) for _, b in made]
    srv = SpiralServerTorch(TINY, "cpu")
    pps = [pp_to_device(TINY, pp, "cpu") for pp, _ in reqs]
    assert set(pps[0]) == {"v_packing"}
    cols, v_fold, v_neg = srv.query_to_device(pps, [q for _, q in reqs], 4)
    crt, n, dim0 = 2, TINY.poly_len, 1 << TINY.db_dim_1
    assert cols.shape == (crt, n, dim0, 8) and cols.dtype == torch.int32
    by_query = cols.reshape(crt, n, dim0, 4, 2)
    jsrv = SpiralServerJax(J(TINY))
    for i, (_, bq) in enumerate(made):
        qj = client_j.Query.deserialize(J(TINY), bq[TINY.setup_bytes():])
        q_arr, vf = jsrv.query_to_device({}, qj)
        np.testing.assert_array_equal(by_query[:, :, :, i].numpy(),
                                      np.asarray(q_arr).astype(np.int32))
        np.testing.assert_array_equal(v_fold[i].numpy(),
                                      np.asarray(vf).astype(np.int32))
    assert torch.equal(by_query[:, :, :, 3], by_query[:, :, :, 0])
    one_cols, one_fold = srv.direct_query(reqs[1][1])
    assert torch.equal(one_cols, by_query[:, :, :, 1])
    assert torch.equal(one_fold, v_fold[1])
    # the negations, with 0 and q_c - 1 words planted
    keys = v_fold.clone()
    for c, q in enumerate(TINY.moduli):
        keys[0, 0, 0, 0, c, :64] = 0
        keys[1, 1, 1, 3, c, ::3] = q - 1
    keys[2, 0, 1] = 0
    gadget = srv.gadget_ntt
    want = jax.jit(lambda v: sjj.get_v_folding_neg(
        J(TINY), v, gadget.numpy().astype(np.uint32)))(
            jnp.asarray(keys.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(
        sj.negate_folding_keys(TINY, keys, gadget).numpy(),
        np.asarray(want).astype(np.int32))
    assert torch.equal(v_neg, sj.negate_folding_keys(TINY, v_fold, gadget))


def test_set_populated_dim0_keeps_no_plan_for_direct_upload():
    """The guard of server_jax.py:243: a direct-upload engine keeps no
    sparse expansion plan for any populated set; an expansion engine of the
    same shapes builds one."""
    direct = SpiralServerTorch(TINY, "cpu")
    direct.set_populated_dim0({1, 2})
    assert direct._splan is None and direct.plan is None
    expand = SpiralServerTorch(get_fast_expansion_testing_params(), "cpu")
    expand.set_populated_dim0({1, 2})
    assert expand._splan is not None


def test_http_e2e_direct_upload_process(tmp_path, case):
    """The port's HTTP service serving a direct-upload JSON from the
    command line (tests/test_kv_service.py:123-155): the Bucket client
    writes and reads privately without /setup, and two direct requests
    arriving in one window are coalesced into one batch."""
    proc, port, _ = spawn(tmp_path, "--batch-window-ms", "300", cfg=CFG)
    try:
        bucket = connect_local(port)
        assert not bucket.params.expand_queries
        bucket.write({"du-key": b"direct upload works"})
        assert bucket.private_read(["du-key"]) == [b"direct upload works"]
        assert bucket._public_uuid == "direct"
        api = API("", f"http://localhost:{port}")
        _, made, _ = case
        got = {}
        gate = threading.Barrier(2)

        def reader(i):
            gate.wait()
            got[i] = api.private_read("", [made[i][1]])[0]

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(got) == 2
        stats = api._get(f"http://localhost:{port}/metrics")["read_coalescer"]
        assert stats["max_batch"] == 2
    finally:
        stop(proc)
