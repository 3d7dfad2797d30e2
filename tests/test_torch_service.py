"""The port's bucket (SpiralKvServerTorch on the CPU): clear, rename,
destroy, the key storage policies, metrics, and checkpoint / restore of the
compact and the dense index, the last also from a checkpoint that the JAX
bucket wrote. Responses are compared byte for byte (tolerance 0).

One JAX bucket, written to and saved but never read
(test_jax_compact_checkpoint...): the port's responses from its checkpoint
are held against the JAX package's numpy oracle over the JAX bucket's rows.
Everything else runs on the port alone.
"""

import base64
import bz2
import json
import math

import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu.kv.write import compress_row as compress_row_j
from sdk_tpu.server.kv_server import SpiralKvServer
from sdk_tpu_torch import convert
from sdk_tpu_torch.client import Client, reframe_decoded_row
from sdk_tpu_torch.clients.bloom import BloomFilter
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.ops.server import index_hbm_bytes
from sdk_tpu_torch.ops.spiral import CompactDb, compact_shape
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import (BucketCapacityError,
                                            SpiralKvServerTorch)

from test_torch_lifecycle import oracle_db, oracle_read

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
CFG = json.dumps(params_to_json_obj(FAST))


def kv_body(kv: dict) -> bytes:
    return json.dumps({k: (base64.b64encode(v).decode() if v else None)
                       for k, v in kv.items()}).encode()


def session(seed: int):
    c = Client(FAST)
    pp = c.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)
    return c, pp.serialize(FAST)


def blob_for(client, uid: str, key: str, seed: int) -> bytes:
    q = client.generate_query(
        row_from_key(FAST.num_items(), key),
        noise_rng=ChaCha20Rng(bytes([seed]) * 32),
        query_seed=bytes([seed + 1]) * 32)
    return uid.encode() + q.serialize(FAST)


def decode(client, key: str, resp: bytes):
    row = reframe_decoded_row(FAST, client.decode_response(resp))
    if not any(row):
        return None
    payload = bz2.BZ2Decompressor().decompress(row)
    try:
        return extract_result(key, payload)
    except KeyError:
        return None


def filled(n_keys: int, **kw) -> tuple:
    srv = SpiralKvServerTorch(FAST, "cpu", CFG, **kw)
    values = {f"key-{i}": f"value-{i}".encode() * 3 for i in range(n_keys)}
    srv.write_kv(kv_body(values))
    return srv, values


def test_clear_returns_to_fresh_compact_index():
    srv, values = filled(60)           # 60 keys over 256 rows: migrates
    client, pp = session(0x10)
    uid = srv.setup_raw(pp)
    blob = blob_for(client, uid, "key-7", 0x20)
    assert decode(client, "key-7", srv.private_read_one(blob)) == values["key-7"]
    assert srv.meta()["index_layout"] == "dense"
    m = srv.metrics()
    assert m["index_bytes"] == index_hbm_bytes(FAST) and m["cap_bin"] is None
    # the rows the index holds: the distinct rows written, in either layout
    rows = {row_from_key(FAST.num_items(), k) for k in values}
    assert srv.engine.index_rows == len(rows) < FAST.num_items()
    v0 = srv.version
    srv.clear()
    meta = srv.meta()
    assert meta["index_layout"] == "compact" and not meta["sparse_expansion"]
    assert meta["global_version"] == v0 + 1
    assert isinstance(srv.engine.db, CompactDb) and srv.engine.db.cap_bin == 8
    assert not srv.engine.db.planes.any() and not srv._populated_items
    assert srv.has_uuid(uid)                       # sessions survive a clear
    assert decode(client, "key-7", srv.private_read_one(blob)) is None
    assert srv.metrics()["num_rows_populated"] == srv.engine.index_rows == 0
    # the bucket takes writes again, from slot 0
    srv.write_kv(kv_body({"key-7": b"again"}))
    assert decode(client, "key-7", srv.private_read_one(blob)) == b"again"
    assert srv.meta()["index_layout"] == "compact"


def test_rename_destroy_and_metrics():
    srv, _ = filled(3)
    srv.rename("renamed")
    assert srv.meta()["name"] == "renamed"
    client, pp = session(0x12)
    uid = srv.setup_raw(pp)
    m = srv.metrics()
    assert m["version"] == 1 and m["num_rows_populated"] == 3
    assert isinstance(m["stages"], dict)
    # the compact index's device bytes and capacity
    assert m["cap_bin"] == 8
    assert m["index_bytes"] == math.prod(compact_shape(FAST, 8))
    srv.destroy()
    assert srv.destroyed and not srv.has_uuid(uid)
    assert srv.metrics()["num_rows_populated"] == 0
    with pytest.raises(KeyError):
        srv.private_read_one(blob_for(client, uid, "key-1", 0x22))


@pytest.mark.parametrize("policy", ["none", "bloom", "full"])
def test_key_storage_policies(policy):
    srv, values = filled(5, key_storage_policy=policy)
    srv.write_kv(kv_body({"key-1": None}))          # a delete
    if policy == "none":
        with pytest.raises(KeyError):
            srv.bloom_bytes()
    else:
        bloom = BloomFilter.from_bytes(srv.bloom_bytes())
        assert bloom.k == 8
        assert bloom.bits == FAST.db_dim_1 + FAST.db_dim_2 + 6
        assert all(bloom.lookup(k) for k in values)
        assert not bloom.lookup("never-written")
    if policy == "full":
        assert srv.list_keys() == sorted(set(values) - {"key-1"})
    else:
        with pytest.raises(KeyError):
            srv.list_keys()
    srv.clear()
    if policy != "none":
        assert not BloomFilter.from_bytes(srv.bloom_bytes()).lookup("key-0")
    if policy == "full":
        assert srv.list_keys() == []
    with pytest.raises(ValueError):
        SpiralKvServerTorch(FAST, "cpu", key_storage_policy="some")


@pytest.mark.parametrize("layout", ["compact", "dense"])
def test_save_restore_answers_with_the_same_bytes(tmp_path, layout):
    srv, values = filled(6 if layout == "compact" else 40,   # > 32: migrates
                         key_storage_policy="full")
    client, pp = session(0x14)
    uid = srv.setup_raw(pp, "1" * 36)
    blobs = [blob_for(client, uid, k, 0x30 + 2 * i)
             for i, k in enumerate(["key-0", "key-5", "absent"])]
    before = srv.private_read_blobs(blobs)
    assert srv.meta()["index_layout"] == layout
    ckpt = str(tmp_path / "ckpt")
    srv.save_to_dir(ckpt)
    state = json.loads((tmp_path / "ckpt" / "state.json").read_text())
    assert state["db_format"] == layout and state["db_layout"] == "torch"
    assert (tmp_path / "ckpt" / "db_idx_j.npy").exists() == (layout == "compact")

    srv2 = SpiralKvServerTorch(FAST, "cpu", CFG, key_storage_policy="full")
    srv2.restore_from_dir(ckpt)
    srv2.setup_raw(pp, "1" * 36)
    assert srv2.private_read_blobs(blobs) == before
    assert srv2.engine.index_rows == srv.engine.index_rows
    assert srv2.private_read_one(blobs[0]) == before[0]
    meta = srv2.meta()
    assert meta["index_layout"] == layout
    assert meta["global_version"] == srv.version
    assert meta["sparse_expansion"] == srv.meta()["sparse_expansion"]
    assert srv2.list_keys() == srv.list_keys()
    assert srv2.bloom_bytes() == srv.bloom_bytes()
    assert decode(client, "key-5", before[1]) == values["key-5"]
    assert decode(client, "absent", before[2]) is None
    # the restored bucket goes on taking writes into the restored slots
    for s in (srv, srv2):
        s.write_kv(kv_body({"key-0": b"rewritten", "new-key": b"new"}))
    assert srv2.private_read_blobs(blobs) == srv.private_read_blobs(blobs)
    if layout == "compact":
        assert srv2._updates.slots.to_state() == srv._updates.slots.to_state()
        assert torch.equal(srv2.engine.db.idx_j, srv.engine.db.idx_j)


def test_dense_restore_checks_capacity_first(tmp_path):
    srv, _ = filled(60)
    srv.save_to_dir(str(tmp_path / "ckpt"))
    small = SpiralKvServerTorch(FAST, "cpu", CFG, hbm_budget_bytes=1 << 20)
    with pytest.raises(BucketCapacityError):
        small.restore_from_dir(str(tmp_path / "ckpt"))
    assert small.meta()["index_layout"] == "compact"    # untouched


@pytest.mark.parametrize("kind", ["throughput", "legacy-u32"])
def test_tpu_only_checkpoint_formats_are_refused(tmp_path, kind):
    """The JAX bucket's 'throughput' dense layout and its legacy uint32
    checkpoints are refused by name, and the bucket keeps serving."""
    srv, _ = filled(60)
    ckpt = tmp_path / "ckpt"
    srv.save_to_dir(str(ckpt))
    shape = (2, 8, 1, 4, 4, 4, 64) if kind == "throughput" else (1, 4, 2, 8, 4, 64)
    np.save(ckpt / "db_tensor.npy", np.zeros(
        shape, dtype=np.int8 if kind == "throughput" else np.uint32))
    other = SpiralKvServerTorch(FAST, "cpu", CFG)
    with pytest.raises(ValueError, match="throughput" if kind == "throughput"
                       else "legacy"):
        other.restore_from_dir(str(ckpt))
    assert other.meta()["index_layout"] == "compact"
    assert other.warmup() > 0


def test_jax_compact_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint that the JAX bucket wrote in its compact format (its
    plane layout, its CompactSlots state) after writes only restores into
    the port, which then answers a batch with the bytes of the JAX package's
    numpy oracle (server_host) over the JAX bucket's rows, and goes on
    writing into the restored slots as the JAX bucket does."""
    pj = params_j.params_from_json(CFG)
    jax_srv = SpiralKvServer(pj, CFG, key_storage_policy="full")
    values = {f"key-{i}": f"value-{i}".encode() * 3 for i in range(9)}
    jax_srv.write_kv(kv_body(values))
    ckpt = str(tmp_path / "jax-ckpt")
    jax_srv.save_to_dir(ckpt)
    state = json.loads((tmp_path / "jax-ckpt" / "state.json").read_text())
    assert state["db_format"] == "compact" and "db_layout" not in state

    srv = SpiralKvServerTorch(FAST, "cpu", CFG, key_storage_policy="full")
    srv.restore_from_dir(ckpt)
    assert srv.meta()["index_layout"] == "compact"
    assert srv.list_keys() == jax_srv.list_keys()
    assert srv.bloom_bytes() == jax_srv.bloom_bytes()
    assert srv._updates.slots.to_state() == jax_srv._updates.slots.to_state()

    client, pp = session(0x16)
    uid = "2" * 36
    srv.setup_raw(pp, uid)
    blobs = [blob_for(client, uid, k, 0x40 + 2 * i)
             for i, k in enumerate(["key-2", "key-8"])]
    db_h = oracle_db(FAST, {i: compress_row_j(r)
                            for i, r in enumerate(jax_srv.rows) if r})
    want = [oracle_read(FAST, db_h, pp, b) for b in blobs]
    got = srv.private_read_blobs(blobs)
    assert got == want
    assert [srv.private_read_one(b) for b in blobs] == want
    assert decode(client, "key-8", got[1]) == values["key-8"]
    # both go on writing: the same slots, so the same compact planes
    more = kv_body({"key-2": b"changed", "later": b"added"})
    jax_srv.write_kv(more)
    srv.write_kv(more)
    jax_srv._flush()
    srv.flush()
    want_db = convert.compact_from_jax(FAST, jax_srv.engine.db.planes,
                                       jax_srv.engine.db.idx_j)
    assert torch.equal(srv.engine.db.planes, want_db.planes)
    assert torch.equal(srv.engine.db.idx_j, want_db.idx_j)
