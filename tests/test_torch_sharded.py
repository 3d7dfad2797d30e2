"""Sharded serving in the port (sdk_tpu_torch.ops.shard) on logical CPU
meshes: kernel M's plain version against the JAX package's psum_mod under
shard_map, the sharded Spiral engine and bucket against the unsharded port
and the JAX package's numpy oracle (server_host), the row-sharded checklist
against ChecklistServerJax(mesh=), the selfchecks, the mesh specs, kernel
H''s occupancy rule and a --cpu --mesh server process. Every comparison is
exact (tolerance 0).

A logical mesh names the CPU several times, as the JAX tests name XLA's 8
virtual host devices (tests/conftest.py); no JAX Spiral engine is traced
here: the sharded Spiral bytes are held against the unsharded port and the
numpy oracle, JAX only computes psum_mod and the small checklist.
"""

import functools
import json

import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import params as dp_params_j
from sdk_tpu.doublepir.server_jax import ChecklistServerJax
from sdk_tpu.ops import shard as shard_j
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.doublepir import matrix as dp_matrix
from sdk_tpu_torch.doublepir import scheme
from sdk_tpu_torch.doublepir.params import Params as DpParams
from sdk_tpu_torch.doublepir.server_torch import ChecklistServerTorch
from sdk_tpu_torch.kv.ingest import (DbUpdateBuffer, compact_to_dense,
                                     compact_to_dense_plain)
from sdk_tpu_torch.ops import shard
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.ops.spiral import compact_db_empty, db_shape
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.selfcheck import (sharded_doublepir_check,
                                     sharded_protocol_check)
from sdk_tpu_torch.server.kv_server import (BucketCapacityError,
                                            SpiralKvServerTorch)

from test_torch_http import spawn, stop
from test_torch_lifecycle import OracleRows, oracle_db, oracle_read

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
CFG = json.dumps(params_to_json_obj(FAST))
CPU8 = ["cpu"] * 8


def mesh(spec: str) -> shard.Mesh:
    return shard.mesh_from_spec(spec, devices=CPU8)


# ---- kernel M's plain version ---------------------------------------------

@pytest.mark.parametrize("q", FAST.moduli)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_psum_mod_plain_matches_jax(D, q):
    """JAX's psum_mod (16-bit halves through lax.psum) under shard_map on D
    of the 8 virtual CPU devices, against the port's one-pass int64 sum."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(D)
    x = rng.integers(0, q, (D, 256), dtype=np.uint64).astype(np.uint32)
    mesh_j = shard_j.make_mesh(D, dp=1)

    @functools.partial(shard_j.shard_map, mesh=mesh_j,
                       in_specs=P(("dp", "db"), None),
                       out_specs=P(("dp", "db"), None), check_rep=False)
    def f(s):
        return shard_j.psum_mod(s, q, "db")

    want = np.asarray(jax.jit(f)(jnp.asarray(x)))[0]
    got = shard.psum_mod([torch.from_numpy(r.view(np.int32)) for r in x], q)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_psum_mod_plain_wrapping_and_channels(D):
    """q = 0 is the sum mod 2^32 (numpy uint32 adds); the Spiral form
    reduces axis 0's two channels by their own moduli."""
    rng = np.random.default_rng(10 + D)
    x = rng.integers(0, 1 << 32, (D, 3, 5), dtype=np.uint64).astype(np.uint32)
    got = shard.psum_mod([torch.from_numpy(r.view(np.int32)) for r in x], 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  x.sum(axis=0, dtype=np.uint32))
    q0, q1 = FAST.moduli
    y = np.stack([rng.integers(0, q, (D, 4, 6), dtype=np.uint64)
                  for q in (q0, q1)], axis=1)          # (D, 2, 4, 6)
    got = shard.psum_mod([torch.from_numpy(r.astype(np.int32)) for r in y],
                         FAST.moduli)
    want = np.stack([y[:, 0].sum(0) % q0, y[:, 1].sum(0) % q1])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# ---- meshes ----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["dp=2,db=4", "db=8", "4", "dp=2"])
def test_mesh_from_spec_accepts_what_jax_accepts(spec):
    assert mesh(spec).shape == dict(shard_j.mesh_from_spec(spec).shape)


@pytest.mark.parametrize("spec", ["tp=4", "", "dp=2,db=x", "db=16"])
def test_mesh_from_spec_refuses(spec):
    with pytest.raises(ValueError):
        mesh(spec)


def test_default_mesh_takes_distinct_cuda_devices():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="available"):
        shard.make_mesh(have + 1)
    with pytest.raises(TypeError, match="Mesh"):
        SpiralServerTorch(FAST, "cpu", mesh="db=2")


# ---- the Spiral engine -----------------------------------------------------

def replay_expansions(expanded: dict):
    """An engine's expand_queries answered from the queries' cached
    expansions (id(query) -> expand_queries' scan columns, folding keys and
    their negations for that query alone), laid out as the engine lays out
    a batch (padding columns query 0's)."""
    def expand_queries(_pps, queries, columns=None):
        cols = [expanded[id(q)][0] for q in queries]
        cols += cols[:1] * ((columns or len(cols)) - len(cols))
        q_all = torch.stack(cols, dim=-2)
        return (q_all.reshape(q_all.shape[:3] + (-1,)),
                torch.cat([expanded[id(q)][1] for q in queries]),
                torch.cat([expanded[id(q)][2] for q in queries]))
    return expand_queries


@pytest.fixture(scope="module")
def engine_case():
    """A dense index of random rows, three queries of one session, the
    unsharded port's and the oracle's responses, and the queries' dense
    expansions. The expansion runs on the home device whatever the mesh
    (the same code as unsharded serving), so the sharded cases reuse these
    and spend their time in what the mesh changes: scan, sum, fold,
    gather, pack and encode."""
    rng = np.random.default_rng(5)
    row_len = FAST.instances * FAST.n * FAST.n * FAST.bytes_per_chunk()
    targets = [41, 0, 255]
    rows = {i: rng.integers(0, 256, row_len - 9, dtype=np.uint8).tobytes()
            for i in targets + [6, 100, 129]}
    buf = DbUpdateBuffer(FAST, "cpu")
    for i, data in rows.items():
        buf.upsert_raw(i, data)
    dense = buf.flush(torch.zeros(db_shape(FAST), dtype=torch.int8))
    client = Client(FAST)
    pp = client.generate_keys_from_seed(
        b"\x21" * 32, noise_rng=ChaCha20Rng(b"\x22" * 32),
        pp_seed=b"\x23" * 32)
    queries = [client.generate_query(
        t, noise_rng=ChaCha20Rng(bytes([0x24 + k]) * 32),
        query_seed=bytes([0x34 + k]) * 32) for k, t in enumerate(targets)]
    single = SpiralServerTorch(FAST, "cpu")
    single.set_db(dense)
    pp_dev = single._pp_dev(pp)
    expanded = {id(q): single.expand_queries([pp_dev], [q]) for q in queries}
    single.expand_queries = replay_expansions(expanded)
    batch = single.dispatch_queries_batched([(pp_dev, q) for q in queries])()
    db_h = oracle_db(FAST, rows)
    setup = pp.serialize(FAST)
    want = [oracle_read(FAST, db_h, setup, b"u" * 36 + q.serialize(FAST))
            for q in queries]
    assert batch == want
    for t, resp in zip(targets, want):
        assert client.decode_response(resp)[:len(rows[t])] == rows[t]
    return dict(dense=dense, pp=pp_dev, queries=queries, want=want,
                expanded=expanded,
                populated={t >> FAST.db_dim_2 for t in rows})


@pytest.mark.parametrize("spec,sparse", [("db=2", False), ("db=4", False),
                                         ("dp=2,db=2", True),
                                         ("dp=2,db=4", False)])
def test_sharded_engine_matches_unsharded_and_oracle(engine_case, spec,
                                                     sparse):
    """SpiralServerTorch(mesh=): a single read and a batch of three are the
    unsharded port's and server_host's bytes; one case expands sparsely
    over the populated first-dim rows (the same bytes)."""
    c = engine_case
    srv = SpiralServerTorch(FAST, mesh=mesh(spec))
    srv.set_db(c["dense"])
    if sparse:
        srv.set_populated_dim0(c["populated"])
        assert srv._splan is not None
    else:
        srv.expand_queries = replay_expansions(c["expanded"])
    d0 = (1 << FAST.db_dim_1) // srv.mesh.shape["db"]
    assert srv.db.shards[-1][-1].shape[3] == d0 // 4
    assert srv.process_query(c["pp"], c["queries"][0]) == c["want"][0]
    got = srv.dispatch_queries_batched([(c["pp"], q) for q in c["queries"]])()
    assert got == c["want"]


def test_shard_db_refuses_a_db_axis_that_does_not_divide_dim0():
    with pytest.raises(ValueError, match="divide"):
        SpiralServerTorch(FAST, mesh=shard.make_mesh(3, devices=CPU8))


def test_selfchecks():
    sharded_protocol_check(mesh("dp=2,db=4"))
    sharded_doublepir_check(mesh("4"))
    sharded_doublepir_check(mesh("dp=2,db=3"))


# ---- the bucket --------------------------------------------------------------

def kv_body(kv: dict) -> bytes:
    import base64
    return json.dumps({k: base64.b64encode(v).decode()
                       for k, v in kv.items()}).encode()


def read_blobs(client, uid, keys, salt):
    from sdk_tpu_torch.kv.key_value import row_from_key

    return [uid.encode() + client.generate_query(
        row_from_key(FAST.num_items(), k),
        noise_rng=ChaCha20Rng(bytes([salt + i]) * 32),
        query_seed=bytes([salt + 16 + i]) * 32).serialize(FAST)
        for i, k in enumerate(keys)]


def decode(client, key, resp):
    import bz2

    from sdk_tpu_torch.client import reframe_decoded_row
    from sdk_tpu_torch.kv.key_value import extract_result

    row = reframe_decoded_row(FAST, client.decode_response(resp))
    if not any(row):
        return None
    return extract_result(key, bz2.BZ2Decompressor().decompress(row))


def test_sharded_bucket_writes_reads_clear_and_checkpoints(tmp_path):
    """A sharded bucket: writes routed to the shards that hold them, reads
    equal to the oracle over the same rows, /clear zeroing the shards in
    place, and a checkpoint round trip sharded -> unsharded -> sharded with
    the same response bytes."""
    m = mesh("dp=2,db=4")
    srv = SpiralKvServerTorch(FAST, "cpu", CFG, mesh=m)
    assert srv.meta()["index_layout"] == "dense"
    oracle = OracleRows(FAST)
    values = {f"key-{i}": f"value-{i}".encode() * 7 for i in range(12)}
    body = kv_body(values)
    srv.write_kv(body)
    oracle.write_kv(body)
    client = Client(FAST)
    setup = client.generate_keys_from_seed(
        b"\x41" * 32, noise_rng=ChaCha20Rng(b"\x42" * 32),
        pp_seed=b"\x43" * 32).serialize(FAST)
    uid = srv.setup_raw(setup)
    blobs = read_blobs(client, uid, ["key-3", "key-11"], 0x50)
    got = srv.private_read_blobs(blobs)
    db_h = oracle.db(FAST)
    assert got == [oracle_read(FAST, db_h, setup, b) for b in blobs]
    assert decode(client, "key-11", got[1]) == values["key-11"]
    # the shards hold the rows: each shard's slice of the whole index
    assert sum(int(s.count_nonzero()) for r in srv.engine.db.shards
               for s in r) > 0

    ckpt = str(tmp_path / "sharded")
    srv.save_to_dir(ckpt)
    flat = SpiralKvServerTorch(FAST, "cpu", CFG)
    flat.restore_from_dir(ckpt)
    flat.setup_raw(setup, uid)
    assert flat.meta()["index_layout"] == "dense"
    assert flat.private_read_one(blobs[1]) == got[1]
    ckpt2 = str(tmp_path / "flat")
    flat.save_to_dir(ckpt2)
    again = SpiralKvServerTorch(FAST, "cpu", CFG, mesh=mesh("db=4"))
    again.restore_from_dir(ckpt2)
    again.setup_raw(setup, uid)
    assert torch.equal(again.engine.db.read_slice(1, 0, FAST.poly_len),
                       flat.engine.db[1])
    assert again.private_read_one(blobs[0]) == got[0]

    shards_before = [s for r in srv.engine.db.shards for s in r]
    srv.clear()
    assert [s for r in srv.engine.db.shards for s in r] == shards_before
    assert all(not s.any() for s in shards_before)
    assert decode(client, "key-3", srv.private_read_one(blobs[0])) is None


def test_sharded_bucket_capacity_guard_counts_per_device(tmp_path):
    """kv_server.py:148-150: a mesh divides the index over its db axis; a
    budget that holds a quarter of the index per device admits a db=4 mesh
    and refuses db=2, before allocating."""
    from sdk_tpu_torch.ops.server import (index_hbm_bytes,
                                          serving_working_set_bytes)

    budget = (index_hbm_bytes(FAST) // 4
              + serving_working_set_bytes(FAST, nq=16) + 1)
    SpiralKvServerTorch(FAST, "cpu", CFG, hbm_budget_bytes=budget,
                        mesh=mesh("db=4"))
    with pytest.raises(BucketCapacityError, match="GB/device"):
        SpiralKvServerTorch(FAST, "cpu", CFG, hbm_budget_bytes=budget,
                            mesh=mesh("db=2"))
    # a compact checkpoint does not restore into a sharded bucket
    compact = SpiralKvServerTorch(FAST, "cpu", CFG)
    compact.write_kv(kv_body({"k": b"v"}))
    compact.save_to_dir(str(tmp_path))
    with pytest.raises(ValueError, match="sharded"):
        SpiralKvServerTorch(FAST, "cpu", CFG,
                            mesh=mesh("db=2")).restore_from_dir(str(tmp_path))


# ---- the checklist ---------------------------------------------------------

def test_sharded_checklist_matches_jax():
    """ChecklistServerTorch over a logical 4-shard mesh against
    ChecklistServerJax(mesh=make_mesh(4)) (test_doublepir_server_jax.py:96):
    hint, squished H1 and every answer word; l = 13 pads to 24 rows."""
    config = "64,6.4,13,17,32,464"
    params = DpParams.from_string(config)
    num_entries = params.l * params.m * 8 - 5
    rng = np.random.default_rng(3)
    bit_bytes = rng.integers(0, 256, (num_entries + 7) // 8,
                             dtype=np.uint16).astype(np.uint8)
    shared = [rng.integers(0, 1 << 32, s, dtype=np.uint64).astype(np.uint32)
              for s in ((params.m, params.n), (params.l, params.n))]
    srv_j = ChecklistServerJax(num_entries,
                               dp_params_j.Params.from_string(config),
                               bit_bytes, mesh=shard_j.make_mesh(4))
    hint_j = srv_j.setup(shared)
    srv_t = ChecklistServerTorch(num_entries, params, bit_bytes,
                                 mesh=mesh("4"))
    assert srv_t.l_pad == srv_j.l_pad == 24
    hint_t = srv_t.setup(shared)
    np.testing.assert_array_equal(hint_t[0], hint_j[0])
    np.testing.assert_array_equal(srv_t.h1_sq, np.asarray(srv_j.h1_sq))
    qrng = np.random.default_rng(23)
    all_bits = np.unpackbits(bit_bytes, bitorder="little")[:num_entries]
    targets = [int(np.flatnonzero(all_bits == 1)[1]),
               int(np.flatnonzero(all_bits == 0)[1]), 5]
    queries = [scheme.query(t, shared, params, srv_t.info, qrng)[1]
               for t in targets]
    want = srv_j.answer(queries)
    got = srv_t.answer(queries)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # restore path: the sharded squished H1 installs back
    other = ChecklistServerTorch(num_entries, params, bit_bytes,
                                 mesh=mesh("4"))
    other.install_hint(srv_t.h1_sq, shared[1])
    for g, w in zip(other.answer(queries), want):
        np.testing.assert_array_equal(g, w)


def test_doublepir_sharded_firstlevel_matches_host():
    """DoublePirShardedScan (shard.py:200-247): rows not divisible by the
    mesh, two row batches, against the host packed matvec."""
    rng = np.random.default_rng(23)
    rows, cols = 104, 12
    db = rng.integers(0, 1 << 10, (rows, cols * 3),
                      dtype=np.uint64).astype(np.uint32)
    dbp = dp_matrix.squish(db)
    q1, q2 = (rng.integers(0, 1 << 32, (cols * 3, 1), dtype=np.uint64)
              .astype(np.uint32) for _ in range(2))
    scan = shard.DoublePirShardedScan(mesh("8"))
    got = scan.answer_firstlevel(scan.shard_rows(dbp), [q1, q2], rows)
    half = rows // 2
    want = np.vstack([dp_matrix.mat_mul_vec_packed(dbp[:half], q1),
                      dp_matrix.mat_mul_vec_packed(dbp[half:], q2)])
    np.testing.assert_array_equal(got, want)


# ---- kernel H': only occupied slots are placed ------------------------------

def test_compact_to_dense_places_an_occupied_slot_at_column_zero():
    """Item 0 sits in bin 0 at dim0 column 0, the idx_j that every
    unoccupied slot also carries: the migration keeps its limbs (a store of
    the unoccupied slots' zeros would wipe them) and equals the dense index
    of the same rows. With bin 0's count at 0 its slots are not placed."""
    rng = np.random.default_rng(12)
    row_len = FAST.instances * FAST.n * FAST.n * FAST.bytes_per_chunk()
    rows = {i: rng.integers(0, 256, row_len, dtype=np.uint8).tobytes()
            for i in (0, 8, 13, 255)}
    comp_buf = DbUpdateBuffer(FAST, "cpu")
    dense_buf = DbUpdateBuffer(FAST, "cpu")
    for i, data in rows.items():
        comp_buf.upsert_raw(i, data)
        dense_buf.upsert_raw(i, data)
    compact = comp_buf.flush(compact_db_empty(FAST, "cpu", cap_bin=4))
    assert int(compact.idx_j[0, comp_buf.slots.slot_of[0]]) == 0
    dense = dense_buf.flush(torch.zeros(db_shape(FAST), dtype=torch.int8))
    counts = comp_buf.slots.bin_count
    assert torch.equal(compact_to_dense(FAST, compact, counts), dense)
    assert dense[:, :, :, 0, :, :, 0, 0].any()
    none_in_bin0 = counts.copy()
    none_in_bin0[0] = 0
    moved = compact_to_dense_plain(FAST, compact, none_in_bin0)
    assert not moved[:, :, :, :, :, :, 0].any()
    assert torch.equal(moved[:, :, :, :, :, :, 1:], dense[:, :, :, :, :, :, 1:])


# ---- a --cpu --mesh server process ------------------------------------------

def test_http_server_cpu_mesh_subprocess(tmp_path):
    """python -m sdk_tpu_torch.server.http 0 params.json --cpu --mesh
    dp=2,db=4: the service serves a dense index cut over 8 logical CPU
    shards; reads decode through the port's client."""
    from sdk_tpu_torch.clients.bucket_service import connect_local

    proc, port, seen = spawn(tmp_path, "--mesh", "dp=2,db=4")
    try:
        assert any("'dp': 2, 'db': 4" in s for s in seen), seen
        bucket = connect_local(port)
        bucket.write({"mesh-a": b"over eight shards", "mesh-b": b"b" * 40})
        assert bucket.private_read(["mesh-b", "mesh-a", "nope"]) == [
            b"b" * 40, b"over eight shards", None]
        assert bucket.info()["index_layout"] == "dense"
    finally:
        stop(proc)
