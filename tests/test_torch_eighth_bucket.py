"""A sparsely written bucket on the port's normal read path, on the CPU at
the fast testing params: an eighth of the rows written at their keys'
hashes (the fullest fill that stays compact), two requests for written and
never-written rows coalesced into one batched read, each answer decoded and
held to a plain dict of the written bytes (zeros for a row never written)
and to the bytes the same writes give in a bucket held dense; each
dispatch's ``engine.index`` record counts the written rows, whichever
layout holds them. A read of the plain CPU path takes ~1 s a query here, so
three rows are read."""

import threading
import time

import numpy as np
import pytest
import torch

from sdk_tpu_torch.client import Client, reframe_decoded_row
from sdk_tpu_torch.kv.key_value import row_from_key
from sdk_tpu_torch.params import get_fast_expansion_testing_params
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.http import ReadCoalescer
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch
from sdk_tpu_torch.telemetry import GLOBAL_TIMERS

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
WIDTH = FAST.instances * FAST.n * FAST.n * FAST.bytes_per_chunk()
WINDOW_S = 1.0          # both requests arrive well inside it
READ = {"written": 2, "never_written": 1}     # rows of each kind read


def key_rows(n: int) -> list[int]:
    """The first n distinct rows of the keys "eighth:0", "eighth:1", ..."""
    rows, i = [], 0
    while len(rows) < n:
        row = row_from_key(FAST.num_items(), f"eighth:{i}")
        if row not in rows:
            rows.append(row)
        i += 1
    return rows


def bucket(written: dict, dense: bool) -> SpiralKvServerTorch:
    srv = SpiralKvServerTorch(FAST, "cpu")
    if dense:
        srv.dense_migrate_fill = 0.0    # migrate at the first flush
    for row, data in written.items():
        srv.update_item_raw(row, data)
    srv.flush()
    return srv


def since(t0: int) -> list:
    return [r for r in GLOBAL_TIMERS.records() if r.t0_ns >= t0]


def coalesced_read(srv, blobs: list) -> tuple:
    """Each list of blobs a request, sent at once through the read
    coalescer; returns their responses, the coalescer's counters and the
    program's records since."""
    reader = ReadCoalescer(srv, WINDOW_S)
    out = [None] * len(blobs)
    t0 = time.monotonic_ns()

    def send(k):
        out[k] = reader.read_blobs(blobs[k])

    threads = [threading.Thread(target=send, args=(k,))
               for k in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out, reader.stats, since(t0)


@pytest.fixture(scope="module")
def eighth():
    rows = key_rows(FAST.num_items() // 8)
    rng = np.random.default_rng(25)
    written = {r: rng.integers(0, 256, WIDTH, dtype=np.uint8).tobytes()
               for r in rows}
    blank = sorted(set(range(FAST.num_items())) - set(rows))
    read = rows[:READ["written"]] + blank[:READ["never_written"]]
    client = Client(FAST)
    pp = client.generate_keys_from_seed(
        b"\x25" * 32, noise_rng=ChaCha20Rng(b"\x26" * 32),
        pp_seed=b"\x27" * 32).serialize(FAST)
    queries = [client.generate_query(
        r, noise_rng=ChaCha20Rng(bytes([0x30 + i]) * 32),
        query_seed=bytes([0x50 + i]) * 32).serialize(FAST)
        for i, r in enumerate(read)]
    # two requests: a written and the never-written row, and a written row
    order = [read[0], read[2], read[1]]
    compact = bucket(written, dense=False)
    uid = compact.setup_raw(pp)
    blobs = [uid.encode() + queries[read.index(r)] for r in order]
    resp, stats, recs = coalesced_read(compact, [blobs[:2], blobs[2:]])
    dense = bucket(written, dense=True)
    dense.setup_raw(pp, uid=uid)
    t0 = time.monotonic_ns()
    dense_resp = dense.private_read_blobs(blobs)
    out = {"compact": {"meta": compact.meta(), "stats": stats,
                       "records": recs,
                       "responses": dict(zip(order, resp[0] + resp[1]))},
           "dense": {"meta": dense.meta(), "records": since(t0),
                     "responses": dict(zip(order, dense_resp))}}
    return {"written": written, "read": read, "client": client, **out}


@pytest.mark.parametrize("kind", sorted(READ))
def test_eighth_bucket_reads_match_the_plain_dict(eighth, kind):
    compact, dense = eighth["compact"], eighth["dense"]
    assert {k: compact["meta"][k] for k in ("index_layout",
                                            "sparse_expansion")} == {
        "index_layout": "compact", "sparse_expansion": False}
    assert dense["meta"]["index_layout"] == "dense"
    # one window: both requests in one dispatch of their three queries
    assert compact["stats"] == {"batches": 1, "requests": 2, "max_batch": 2}
    for run in (compact, dense):
        [disp] = [r for r in run["records"] if r.name == "engine.dispatch"]
        [index] = [r for r in run["records"] if r.name == "engine.index"]
        assert disp.count == len(eighth["read"])
        assert (index.parent, index.trace) == (disp.span, disp.trace)
        assert index.t0_ns == index.t1_ns
        assert index.count == len(eighth["written"])
    n = READ["written"]
    rows = eighth["read"][:n] if kind == "written" else eighth["read"][n:]
    for row in rows:
        want = eighth["written"].get(row, bytes(WIDTH))
        assert (row in eighth["written"]) == (kind == "written")
        resp = compact["responses"][row]
        got = reframe_decoded_row(FAST, eighth["client"].decode_response(resp))
        assert got[:WIDTH] == want
        assert resp == dense["responses"][row]
