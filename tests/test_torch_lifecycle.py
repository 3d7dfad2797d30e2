"""The bucket lifecycle of the port (SpiralKvServerTorch, plain versions on
the CPU) against the JAX bucket (SpiralKvServer): the same writes and the
same client requests give byte-identical responses, and each decodes.

Fast params (256 items, dim0 64, num_per 4) with the JAX bucket's
thresholds: sparse expansion while at most 16 first-dim rows are
populated, migration once more than 32 items are.

  S1  compact index, sparse expansion   (this file)
  S2  compact index, dense expansion    (this file)
  S3  migrated to the dense index       (tests/test_torch_migration.py)

Each state compares a batch of three (two sessions, padded to four scan
column pairs) with the JAX bucket's batched read, byte for byte, and the
port's single read with the batch's first response: the JAX bucket's
batched program answers the same request in its first column, so the single
read is held against the JAX package through it, without tracing the JAX
single-read program of every state as well (one JAX compile per state
instead of two). Every batched response must decode.
"""

import base64
import bz2
import json

import numpy as np
import torch

from sdk_tpu import params as params_j
from sdk_tpu.server.kv_server import SpiralKvServer
from sdk_tpu_torch import params as params_t
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.ops.spiral import CompactDb
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

torch.set_num_threads(1)


class Pair:
    """One port bucket and one JAX bucket fed the same calls, with two
    client sessions set up in both under the same uids."""

    def __init__(self):
        self.pt = params_t.get_fast_expansion_testing_params()
        self.pj = params_j.get_fast_expansion_testing_params()
        self.port = SpiralKvServerTorch(self.pt, "cpu")
        self.jax = SpiralKvServer(self.pj)
        self.clients, self.uids = [], []
        for s in range(2):
            c = Client(self.pt)
            pp = c.generate_keys_from_seed(
                bytes([0x51 + s]) * 32,
                noise_rng=ChaCha20Rng(bytes([0x61 + s]) * 32),
                pp_seed=bytes([0x71 + s]) * 32)
            raw = pp.serialize(self.pt)
            uid = self.port.setup_raw(raw)
            assert self.jax.setup_raw(raw, uid) == uid
            self.clients.append(c)
            self.uids.append(uid)

    def write_kv(self, kv: dict) -> None:
        body = json.dumps({k: base64.b64encode(v).decode()
                           for k, v in kv.items()}).encode()
        self.port.write_kv(body)
        self.jax.write_kv(body)

    def write_rows(self, rows: dict) -> None:
        for i, data in rows.items():
            self.port.update_item_raw(i, data)
            self.jax.update_item_raw(i, data)

    def blob(self, s: int, idx: int, salt: int) -> bytes:
        q = self.clients[s].generate_query(
            idx, noise_rng=ChaCha20Rng(bytes([0x80 + salt]) * 32),
            query_seed=bytes([0xA0 + salt]) * 32)
        return self.uids[s].encode() + q.serialize(self.pt)

    def read(self, blob: bytes, with_jax: bool = True) -> bytes:
        got = self.port.private_read_one(blob)
        if with_jax:
            assert got == self.jax.private_read_one(blob)
        return got

    def batch(self, blobs: list, with_jax: bool = True) -> list:
        got = self.port.dispatch_read_blobs(blobs)()
        if with_jax:
            assert got == self.jax.private_read_blobs(blobs)
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
    single = pair.read(blobs[0], with_jax=False)
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
    single = pair.read(blobs[0], with_jax=False)
    assert pair.layout() == ("compact", False)
    resps = pair.batch(blobs)
    assert resps[0] == single
    check_rows(pair, blobs, resps, [0, 1, 0], rows, targets)
