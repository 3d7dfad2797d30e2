"""The port's tracer (sdk_tpu_torch.telemetry) on the served read path, on
the CPU at the fast testing params: two concurrent /private-read requests
coalesced into one dispatch, the spans' tree and nesting, /metrics, and the
ring's bound."""

import base64
import gc
import json
import threading
import time
import urllib.request

import torch

from sdk_tpu_torch.client import Client
from sdk_tpu_torch.params import get_fast_expansion_testing_params
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server import http as http_t
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch
from sdk_tpu_torch.telemetry import GLOBAL_TIMERS, StageTimers

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
WINDOW_MS = 1000.0      # both requests arrive well inside it
SERVED = {"http.private_read", "coalescer.window", "coalescer.wait",
          "coalescer.batch", "bucket.lock_wait", "bucket.flush",
          "bucket.parse", "engine.dispatch", "engine.fetch",
          "engine.to_bytes"}


def post(port: int, body: bytes) -> list:
    req = urllib.request.Request(f"http://localhost:{port}/private-read",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_two_coalesced_requests_make_one_traced_dispatch():
    srv = SpiralKvServerTorch(FAST, "cpu")
    srv.update_item_raw(3, b"three")
    client = Client(FAST)
    pp = client.generate_keys_from_seed(
        b"\x11" * 32, noise_rng=ChaCha20Rng(b"\x12" * 32),
        pp_seed=b"\x13" * 32)
    uid = srv.setup_raw(pp.serialize(FAST))
    bodies = [json.dumps([base64.b64encode(uid.encode() + client.generate_query(
        3, noise_rng=ChaCha20Rng(bytes([0x20 + k]) * 32),
        query_seed=bytes([0x30 + k]) * 32).serialize(FAST)).decode()]
        * (k + 1)).encode() for k in range(2)]
    httpd = http_t.serve(srv, 0, block=False, batch_window_ms=WINDOW_MS)
    port = httpd.server_address[1]
    t0 = time.monotonic_ns()
    try:
        out = [None, None]
        threads = [threading.Thread(target=lambda k=k: out.__setitem__(
            k, post(port, bodies[k]))) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with urllib.request.urlopen(f"http://localhost:{port}/metrics",
                                    timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert [len(o) for o in out] == [1, 2]

    recs = [r for r in GLOBAL_TIMERS.records() if r.t0_ns >= t0]
    [disp] = [r for r in recs if r.name == "engine.dispatch"]
    assert disp.count == 3                  # the two requests' queries
    by_id = {r.span: r for r in recs}
    handlers = [r for r in recs if r.name == "http.private_read"]
    assert len(handlers) == 2 and len({h.trace for h in handlers}) == 2
    for h in handlers:
        kids = [r for r in recs if r.parent == h.span]
        assert kids and all(r.trace == disp.trace for r in kids)
        assert {r.name for r in kids} in ({"coalescer.wait"},
                                          {"coalescer.window",
                                           "coalescer.batch"})
    for r in recs:                          # spans nest in time
        assert r.t0_ns <= r.t1_ns
        if r.parent in by_id:
            p = by_id[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    [batch] = [r for r in recs if r.name == "coalescer.batch"]
    assert batch.count == 2
    inside = {r.name: r for r in recs if r.parent == batch.span}
    assert set(inside) == {"bucket.lock_wait", "bucket.flush",
                           "bucket.parse", "engine.dispatch",
                           "engine.fetch", "engine.to_bytes"}
    # flush and parse run under the lock, which is released before the fetch
    order = ["bucket.lock_wait", "bucket.flush", "bucket.parse",
             "engine.dispatch", "engine.fetch", "engine.to_bytes"]
    for a, b in zip(order, order[1:]):
        assert inside[a].t1_ns <= inside[b].t0_ns, (a, b)
    assert not [r for r in recs if r.name.startswith("device.")]
    # the rows the scanned index holds, a zero-length record in the enqueue
    [index] = [r for r in recs if r.name == "engine.index"]
    assert (index.parent, index.trace, index.count) == (disp.span,
                                                        disp.trace, 1)
    assert disp.t0_ns <= index.t0_ns == index.t1_ns <= disp.t1_ns

    assert SERVED <= set(metrics["stages"])
    assert "query_fused" not in metrics["stages"]
    assert metrics["read_coalescer"] == {"batches": 1, "requests": 2,
                                         "max_batch": 2}


def test_the_ring_stays_bounded():
    timers = StageTimers(ring=8)
    for k in range(20):
        with timers.span("outer", k):
            with timers.span("inner"):
                pass
    recs = timers.records()
    assert len(recs) == 8 and recs[-1].name == "outer" and recs[-1].count == 19
    assert recs[-2].parent == recs[-1].span == recs[-2].trace
    assert timers.snapshot()["outer"]["count"] == 20


def test_recording_keeps_nothing_for_the_collector():
    """Records, while the ring fills as when it is full, leave no more live
    objects that the garbage collector tracks, so the served path never
    sets off its passes (which hold every thread) for the tracer's sake."""
    timers = StageTimers(ring=4096)
    with timers.span("outer"):                # the names
        timers.add("device.stage", 0, 1)
    gc.disable()
    try:
        before = gc.get_count()[0]
        for k in range(1000):
            with timers.span("outer", k):
                timers.add("device.stage", 0, k, count=k)
        grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert grown < 10
    assert [(r.name, r.count) for r in timers.records()[-2:]] == [
        ("device.stage", 999), ("outer", 999)]
