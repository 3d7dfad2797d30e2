"""The port's bucket server (SpiralKvServerTorch) and device ingest
(sdk_tpu_torch.kv.ingest), plain versions on the CPU, against the JAX
ingest and the host-built DB tensor; a written key reads back privately.
The port's Params and client come from the port's own modules."""

import base64
import bz2
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu import server_host
from sdk_tpu.kv import ingest as ingest_jax
from sdk_tpu_torch import convert
from sdk_tpu_torch.client import Client, PublicParameters, Query
from sdk_tpu_torch.kv import ingest
from sdk_tpu_torch.kv.ingest import DbUpdateBuffer, ingest_items_device
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.ops.spiral import CompactDb, db_shape
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  get_no_expansion_testing_params,
                                  params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()


def J(params):
    """The JAX package's Params of the same JSON as the port's ``params``."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def session(params, seed: int):
    c = Client(params)
    pp = c.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)
    return c, PublicParameters.deserialize(params, pp.serialize(params))


def query_for(params, client, idx: int, seed: int) -> Query:
    q = client.generate_query(idx, noise_rng=ChaCha20Rng(bytes([seed]) * 32),
                              query_seed=bytes([seed + 1]) * 32)
    return Query.deserialize(params, q.serialize(params))


def test_kv_write_then_private_read():
    params = FAST
    srv = SpiralKvServerTorch(params, device="cpu")
    values = {"alpha": b"\x01" * 300, "bravo": bytes(range(256))}
    srv.write_kv(json.dumps({k: base64.b64encode(v).decode()
                             for k, v in values.items()}).encode())
    client, pp = session(params, 0x50)
    uid = srv.setup(json.dumps(base64.b64encode(
        pp.serialize(params)).decode()).encode())
    assert uid in srv.pub_params and srv.meta()["global_version"] == 1
    for i, key in enumerate(values):
        q = query_for(params, client, row_from_key(params.num_items(), key),
                      0x60 + 2 * i)
        body = json.dumps([base64.b64encode(
            uid.encode() + q.serialize(params)).decode()]).encode()
        resp = base64.b64decode(json.loads(srv.private_read(body))[0])
        payload = bz2.decompress(client.decode_response(resp))
        assert extract_result(key, payload) == values[key]


@pytest.mark.parametrize("params", [FAST, get_no_expansion_testing_params()],
                         ids=["p256", "p65536"])
def test_ingest_matches_jax(params):
    rng = np.random.default_rng(19)
    raw = rng.integers(0, 256, (2, params.instances * params.n * params.n,
                                params.bytes_per_chunk()), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda rb: ingest_jax.ingest_items_device(
        J(params), rb))(jnp.asarray(raw)))
    got = ingest_items_device(params, torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_raw_rows_read_back_through_private_read_one():
    """update_many_items (length-prefixed update_item bodies) then
    private_read_one; warmup runs a throwaway round and leaves no session."""
    params = FAST
    srv = SpiralKvServerTorch(params, device="cpu")
    assert srv.warmup() > 0 and not srv.pub_params
    rng = np.random.default_rng(21)
    rows = {9: rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
            130: rng.integers(0, 256, 90, dtype=np.uint8).tobytes()}
    body = b"".join(len(b).to_bytes(4, "big") + b for b in (
        idx.to_bytes(4, "big") + data for idx, data in rows.items()))
    assert srv.update_many_items(body) == 4 + 700
    client, pp = session(params, 0x70)
    uid = srv.setup_raw(pp.serialize(params))
    q = query_for(params, client, 9, 0x74)
    resp = srv.private_read_one(uid.encode() + q.serialize(params))
    assert client.decode_response(resp)[:700] == rows[9]


def test_capacity_guard_refuses_before_allocating():
    """A new bucket starts compact, so the guard runs before the dense
    index is allocated: at the migration, which a too-small budget refuses
    (the bucket stays compact)."""
    from sdk_tpu_torch.server.kv_server import BucketCapacityError

    srv = SpiralKvServerTorch(FAST, device="cpu", hbm_budget_bytes=1 << 20)
    with pytest.raises(BucketCapacityError, match="Max bucket"):
        srv._check_capacity()
    srv.dense_migrate_fill = 0.0
    srv.update_item_raw(5, b"\x01" * 64)
    srv.flush()
    assert srv._migration_refused
    assert isinstance(srv.engine.db, CompactDb)


def test_flush_matches_host_db(monkeypatch):
    """Rows flushed in place through the device ingest (in chunks smaller
    than the pending set) equal the host-built DB tensor of those rows."""
    params = FAST
    rng = np.random.default_rng(20)
    n_chunks, pt_len = params.instances * params.n * params.n, \
        params.bytes_per_chunk()
    idxs = [0, 3, 64, 65, 130, 255]
    monkeypatch.setattr(ingest, "FLUSH_CHUNK_ITEMS", 4)
    buf = DbUpdateBuffer(params, "cpu")
    items = np.zeros((params.instances, params.n * params.n,
                      params.num_items(), params.poly_len), dtype=np.uint64)
    for idx in idxs:
        data = rng.integers(0, 256, n_chunks * pt_len - 7, dtype=np.uint8)
        buf.upsert_raw(idx, data.tobytes())
        padded = np.concatenate([data, np.zeros(7, dtype=np.uint8)])
        items[:, :, idx] = padded.reshape(params.instances,
                                          params.n * params.n, pt_len)
    db = torch.zeros(db_shape(params), dtype=torch.int8)
    buf.flush(db)
    want = convert.db_from_host_tensor(
        params, server_host.build_db_tensor(J(params), items))
    assert torch.equal(db, want)
