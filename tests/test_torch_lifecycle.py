"""The bucket lifecycle of the port (SpiralKvServerTorch, plain versions on
the CPU) against the JAX package's numpy oracle: the same writes and the
same client requests give byte-identical responses, and each decodes.

Fast params (256 items, dim0 64, num_per 4) with the JAX bucket's
thresholds: sparse expansion while at most 16 first-dim rows are
populated, migration once more than 32 items are.

  S1  compact index, sparse expansion   (this file)
  S2  compact index, dense expansion    (this file)
  S3  migrated to the dense index       (tests/test_torch_migration.py)

Each state compares a batch of three (two sessions, padded to four scan
column pairs) with ``sdk_tpu.server_host.process_query`` over the dense DB
of the same rows, byte for byte, and the port's single read with the
batch's first response. The compact index and sparse expansion answer with
the dense index's bytes, so the dense oracle holds every state; the JAX
bucket's own compact and sparse programs are held against the port by
tests/test_torch_compact.py. The rows the oracle reads come from the JAX
package's KV layer (``sdk_tpu.kv.write``), fed the same writes. Every
batched response must decode.
"""

import base64
import bz2
import json

import numpy as np
import torch

from sdk_tpu import client as client_j, params as params_j, server_host
from sdk_tpu.kv import write as write_j
from sdk_tpu.kv.ingest import chunk_bytes_to_modp_words
from sdk_tpu.kv.key_value import row_from_key as row_from_key_j
from sdk_tpu_torch import params as params_t
from sdk_tpu_torch.params import params_to_json_obj
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.ops.spiral import CompactDb
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

torch.set_num_threads(1)


def J(params):
    """The JAX package's Params of the same configuration."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def oracle_db(params, rows: dict) -> np.ndarray:
    """The dense host DB tensor (server_host.build_db_tensor) of raw
    compressed rows {item index: bytes}, zero-padded as the bucket pads
    them."""
    pj = J(params)
    inst, trials = pj.instances, pj.n * pj.n
    pt_len = pj.bytes_per_chunk()
    items = np.zeros((inst, trials, pj.num_items(), pj.poly_len),
                     dtype=np.uint64)
    for idx, data in rows.items():
        buf = np.zeros(inst * trials * pt_len, dtype=np.uint8)
        buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        words = chunk_bytes_to_modp_words(pj, buf.reshape(-1, pt_len))
        items[:, :, idx, :words.shape[1]] = words.reshape(inst, trials, -1)
    return server_host.build_db_tensor(pj, items)


def oracle_read(params, db: np.ndarray, setup: bytes, blob: bytes) -> bytes:
    """server_host.process_query of one request blob (uuid + query bytes)
    for the session whose serialized public parameters are ``setup``."""
    pj = J(params)
    return server_host.process_query(
        pj, client_j.PublicParameters.deserialize(pj, setup),
        client_j.Query.deserialize(pj, blob[36:]), db)


class OracleRows:
    """The JAX package's KV layer fed the same writes as a bucket: the raw
    compressed rows a bucket ingests (sdk_tpu/server/kv_server.py
    write_kv / update_item_raw)."""

    def __init__(self, params):
        self.num_items = params.num_items()
        self.kv_rows: dict[int, bytearray] = {}
        self.raw: dict[int, bytes] = {}

    def write_kv(self, body: bytes) -> None:
        by_row: dict[int, list] = {}
        for k, v in write_j.unwrap_kv_pairs(body):
            by_row.setdefault(row_from_key_j(self.num_items, k),
                              []).append((k, v))
        for row_id in sorted(by_row):
            row = self.kv_rows.setdefault(row_id, bytearray())
            for k, v in by_row[row_id]:
                write_j.update_row(row, k, v)
            self.raw[row_id] = write_j.compress_row(row)

    def db(self, params) -> np.ndarray:
        return oracle_db(params, self.raw)


class Pair:
    """One port bucket and the oracle's rows fed the same calls, with two
    client sessions set up under fixed uids."""

    def __init__(self):
        self.pt = params_t.get_fast_expansion_testing_params()
        self.port = SpiralKvServerTorch(self.pt, "cpu")
        self.oracle = OracleRows(self.pt)
        self.clients, self.uids, self.setups = [], [], []
        for s in range(2):
            c = Client(self.pt)
            pp = c.generate_keys_from_seed(
                bytes([0x51 + s]) * 32,
                noise_rng=ChaCha20Rng(bytes([0x61 + s]) * 32),
                pp_seed=bytes([0x71 + s]) * 32)
            raw = pp.serialize(self.pt)
            self.uids.append(self.port.setup_raw(raw))
            self.clients.append(c)
            self.setups.append(raw)

    def write_kv(self, kv: dict) -> None:
        body = json.dumps({k: base64.b64encode(v).decode()
                           for k, v in kv.items()}).encode()
        self.port.write_kv(body)
        self.oracle.write_kv(body)

    def write_rows(self, rows: dict) -> None:
        for i, data in rows.items():
            self.port.update_item_raw(i, data)
            self.oracle.raw[i] = data

    def blob(self, s: int, idx: int, salt: int) -> bytes:
        q = self.clients[s].generate_query(
            idx, noise_rng=ChaCha20Rng(bytes([0x80 + salt]) * 32),
            query_seed=bytes([0xA0 + salt]) * 32)
        return self.uids[s].encode() + q.serialize(self.pt)

    def read(self, blob: bytes) -> bytes:
        return self.port.private_read_one(blob)

    def batch(self, blobs: list, with_oracle: bool = True) -> list:
        got = self.port.dispatch_read_blobs(blobs)()
        if with_oracle:
            db = self.oracle.db(self.pt)
            want = [oracle_read(self.pt, db,
                                self.setups[self.uids.index(b[:36].decode())],
                                b) for b in blobs]
            assert got == want
        return got

    def layout(self) -> tuple:
        meta = self.port.meta()
        compact = isinstance(self.port.engine.db, CompactDb)
        assert meta["index_layout"] == ("compact" if compact else "dense")
        assert meta["sparse_expansion"] == (self.port.engine._splan
                                            is not None)
        return meta["index_layout"], meta["sparse_expansion"]


def rand_rows(params, rng, idxs) -> dict:
    n = params.instances * params.n * params.n * params.bytes_per_chunk()
    return {i: rng.integers(0, 256, n - 5, dtype=np.uint8).tobytes()
            for i in idxs}


def check_rows(pair: Pair, blobs: list, resps: list, owners: list,
               rows: dict, targets: list) -> None:
    for b, resp, s, t in zip(blobs, resps, owners, targets):
        assert pair.clients[s].decode_response(resp)[:len(rows[t])] == rows[t]


def test_s1_compact_sparse_matches_jax():
    pair = Pair()
    values = {"alpha": b"\x01" * 300, "bravo": bytes(range(256)),
              "charlie": b"xyz" * 50}
    pair.write_kv(values)
    pair.port.flush()
    assert pair.layout() == ("compact", True)
    assert pair.port.engine.db.cap_bin == 8
    n = pair.pt.num_items()

    def check(s, resp, key):
        payload = bz2.decompress(pair.clients[s].decode_response(resp))
        assert extract_result(key, payload) == values[key]

    keys = list(values)
    blobs = [pair.blob(i % 2, row_from_key(n, k), i)
             for i, k in enumerate(keys)]
    single = pair.read(blobs[0])
    check(0, single, keys[0])
    resps = pair.batch(blobs)
    assert resps[0] == single
    for i, (k, resp) in enumerate(zip(keys, resps)):
        check(i % 2, resp, k)


def test_s2_compact_dense_expansion_matches_jax():
    pair = Pair()
    rng = np.random.default_rng(22)
    # 24 items in 24 first-dim rows: past the sparse limit (16 rows),
    # under the migration limit (32 items)
    rows = rand_rows(pair.pt, rng, [9 * i for i in range(24)])
    pair.write_rows(rows)
    targets = [45, 9, 207]
    blobs = [pair.blob(i % 2, t, 10 + i) for i, t in enumerate(targets)]
    single = pair.read(blobs[0])
    assert pair.layout() == ("compact", False)
    resps = pair.batch(blobs)
    assert resps[0] == single
    check_rows(pair, blobs, resps, [0, 1, 0], rows, targets)
