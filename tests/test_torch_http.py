"""The port's HTTP bucket service (sdk_tpu_torch.server.http) with the port's
client SDK (sdk_tpu_torch.clients) over localhost, on the CPU: the cases of
tests/test_kv_service.py, tests/test_concurrent_serving.py and
tests/test_e2e_subprocess.py against the port, the read coalescer, the
presigned upload flow, and /private-read response bytes against the JAX
service's for the same writes and query blobs (tolerance 0).

Servers bind port 0 (a free port of the system's choice). One JAX server and
one JAX batched read program in the whole file.
"""

import asyncio
import base64
import bz2
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from sdk_tpu_torch.client import Client, reframe_decoded_row
from sdk_tpu_torch.clients.api import API, ApiError
from sdk_tpu_torch.clients.async_bucket import AsyncBucket
from sdk_tpu_torch.clients.bloom import BloomFilter
from sdk_tpu_torch.clients.bucket import Bucket
from sdk_tpu_torch.clients.bucket_service import BucketService, connect_local
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.kv.write import unwrap_kv_pairs, update_row
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server import http as http_t
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
CFG = json.dumps(params_to_json_obj(FAST))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_row_from_key_goldens():
    # reference config: nu_1=9, nu_2=5 -> 2^14 items (key_value.rs:71-98)
    assert row_from_key(1 << 14, "CA") == 4825
    assert row_from_key(1 << 14, "OR") == 8359


def test_update_row_insert_replace_delete():
    row = bytearray()
    update_row(row, "alpha", b"first")
    update_row(row, "beta", b"second")
    assert extract_result("alpha", bytes(row)) == b"first"
    update_row(row, "alpha", b"replaced-longer-value")
    assert extract_result("alpha", bytes(row)) == b"replaced-longer-value"
    assert extract_result("beta", bytes(row)) == b"second"
    update_row(row, "alpha", b"")      # delete
    with pytest.raises(KeyError):
        extract_result("alpha", bytes(row))
    assert extract_result("beta", bytes(row)) == b"second"


def test_unwrap_kv_pairs():
    body = json.dumps({"k1": base64.b64encode(b"v1").decode(),
                       "k2": None}).encode()
    pairs = dict(unwrap_kv_pairs(body))
    assert pairs == {"k1": b"v1", "k2": b""}


def key_to_gold_value(key: str, size: int = 80) -> bytes:
    """Deterministic key->value hashing (test_service.py:11-18 pattern)."""
    out = bytearray()
    cur = key.encode()
    while len(out) < size:
        cur = hashlib.sha256(cur).digest()
        out.extend(cur)
    return bytes(out[:size])


def start(srv, window_ms: float = 0.0):
    httpd = http_t.serve(srv, 0, block=False, batch_window_ms=window_ms)
    return httpd, httpd.server_address[1]


@pytest.fixture(scope="module")
def live_server():
    srv = SpiralKvServerTorch(FAST, "cpu", CFG, key_storage_policy="full")
    httpd, port = start(srv)
    yield port, srv
    httpd.shutdown()


def test_http_e2e_write_read(live_server):
    bucket = connect_local(live_server[0])
    keys = ["CA", "OR", "hello-world"]
    bucket.write({k: key_to_gold_value(k) for k in keys})
    got = bucket.private_read(["CA", "hello-world"])
    assert got == [key_to_gold_value("CA"), key_to_gold_value("hello-world")]
    assert bucket.private_read(["missing-key"]) == [None]


def test_http_e2e_delete_and_update(live_server):
    bucket = connect_local(live_server[0])
    bucket.write({"temp-key": b"ephemeral", "keep-key": b"stays"})
    assert bucket.private_read(["temp-key"]) == [b"ephemeral"]
    bucket.delete_key("temp-key")
    assert bucket.private_read(["temp-key"]) == [None]
    assert bucket.private_read(["keep-key"]) == [b"stays"]
    bucket.write({"keep-key": b"updated"})
    assert bucket.private_read(["keep-key"]) == [b"updated"]


def test_http_meta_version_increments(live_server):
    api = API("", f"http://localhost:{live_server[0]}")
    v0 = api.meta()["global_version"]
    api.write("", {"vkey": "dGVzdA=="})
    assert api.meta()["global_version"] == v0 + 1


def test_http_routes_beside_read_and_write(live_server):
    """/, /metrics, /<uuid>/check, /bloom, /list-keys, /modify, /update-row,
    an unknown route, an unknown uuid, and the presigned upload flow."""
    port, srv = live_server
    base = f"http://localhost:{port}"
    api = API("", base)
    bucket = Bucket(api)
    bucket.write({"route-key": b"route-value"})
    with urllib.request.urlopen(base + "/") as r:
        assert r.read() == f"Hello {FAST.poly_len}!".encode()
    metrics = api._get(base + "/metrics")
    assert metrics["read_coalescer"] == {"batches": 0, "requests": 0,
                                         "max_batch": 0}
    assert metrics["num_rows_populated"] >= 1
    bloom = BloomFilter.from_bytes(base64.b64decode(
        api._get(base + "/bloom")["bloom"]))
    assert bloom.lookup("route-key") and not bloom.lookup("no-such-key")
    assert "route-key" in api._get(base + "/list-keys")
    assert bucket.private_key_intersect(["route-key", "no-such-key"]) \
        == ["route-key"]
    bucket.rename("renamed-bucket")
    assert api.meta()["name"] == "renamed-bucket"
    # presigned upload: prelim {"length": N} -> /upload/<token> multipart
    client = Client(FAST)
    setup = client.generate_keys().serialize(FAST)
    uid = api.setup_presigned("", setup)
    assert api.check(uid) and srv.has_uuid(uid)
    assert not api.check("00000000-0000-4000-8000-000000000000")
    idx = row_from_key(FAST.num_items(), "route-key")
    resp = api.private_read("", [uid.encode() + client.generate_query(
        idx).serialize(FAST)])[0]
    row = reframe_decoded_row(FAST, client.decode_response(resp))
    assert extract_result("route-key", bz2.BZ2Decompressor().decompress(row)) \
        == b"route-value"
    with pytest.raises(ApiError) as e:      # a promised length that is wrong
        prelim = api._post(base + "/setup", b'{"length": 5}', compress=False)
        api._post_form_data(base + prelim["url"], {}, setup)
    assert e.value.code == 400
    # ?uuid= registers the params under a given id
    forced = "3" * 36
    api._post(base + f"/setup?uuid={forced}", json.dumps(
        base64.b64encode(setup).decode()).encode(), compress=False)
    assert srv.has_uuid(forced)
    # raw rows
    data = b"raw row bytes"
    item = (7).to_bytes(4, "big") + data
    out = api._post(base + "/update-row",
                    len(item).to_bytes(4, "big") + item)
    assert out["largest_update"] == len(item)
    for path, code in (("/nothing", 404), ("/private-read", 404)):
        body = b"[]" if code == 404 and path == "/nothing" else json.dumps(
            [base64.b64encode(b"9" * 36 + bytes(FAST.query_bytes()))
             .decode()]).encode()
        with pytest.raises(ApiError) as e:
            api._post(base + path, body, compress=False)
        assert e.value.code == code


def test_direct_upload_params_are_refused():
    """Direct-upload queries are not ported: the bucket says so at
    construction (tests/test_kv_service.py serves such a bucket from the
    JAX package)."""
    params = params_from_json(
        '{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
        ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
        ' "t_exp_right": 8}')
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpiralKvServerTorch(params, "cpu")


def read_via_protocol(srv, key: str) -> bytes:
    """tests/util_protocol.py for the port: a fresh client's full read."""
    client = Client(FAST)
    pp = client.generate_keys()
    qbytes = client.generate_query(
        row_from_key(FAST.num_items(), key)).serialize(FAST)
    uid = srv.setup_raw(pp.serialize(FAST))
    resp = srv.private_read_one(uid.encode() + qbytes)
    row = reframe_decoded_row(FAST, client.decode_response(resp))
    return extract_result(key, bz2.BZ2Decompressor().decompress(row))


def write(srv, kv: dict, flush: bool = False) -> None:
    srv.write_kv(json.dumps({k: base64.b64encode(v).decode()
                             for k, v in kv.items()}).encode())
    if flush:
        srv.flush()


def test_warmup_runs_the_serving_path():
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    write(srv, {"wk": b"warm value"})
    assert srv.warmup() > 0
    assert not srv.pub_params          # throwaway session removed
    assert read_via_protocol(srv, "wk") == b"warm value"


def test_reads_interleaved_with_in_place_writes():
    """Reads overlapped with flushing writes from a writer thread: every
    read decodes its key (tests/test_concurrent_serving.py)."""
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    write(srv, {"stable-key": b"stable-value"}, flush=True)
    stop = threading.Event()
    writer_errors: list[BaseException] = []

    def writer():
        i = 0
        while not stop.is_set():
            try:
                write(srv, {f"churn-{i % 7}": f"val-{i}".encode()}, flush=True)
            except BaseException as e:  # noqa: BLE001
                writer_errors.append(e)
                return
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(3):
            assert read_via_protocol(srv, "stable-key") == b"stable-value"
    finally:
        stop.set()
        t.join(timeout=60)
    assert not writer_errors, writer_errors
    write(srv, {"after-key": b"after-value"}, flush=True)
    assert read_via_protocol(srv, "after-key") == b"after-value"


def test_pipelined_dispatch_overlapped_batches():
    """dispatch_read_blobs: batch N+1 dispatched before batch N's fetch,
    a flushing write between the two, fetches out of order."""
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    write(srv, {"pipe-key": b"pipe-value"})
    clients, blobs = [], []
    for _ in range(4):
        c = Client(FAST)
        uid = srv.setup_raw(c.generate_keys().serialize(FAST))
        q = c.generate_query(row_from_key(FAST.num_items(), "pipe-key"))
        clients.append(c)
        blobs.append(uid.encode() + q.serialize(FAST))
    fetch_a = srv.dispatch_read_blobs(blobs[:2])
    write(srv, {"churn": b"x" * 32})
    fetch_b = srv.dispatch_read_blobs(blobs[2:])
    resp_b = fetch_b()
    resp_a = fetch_a()
    for c, r in zip(clients, resp_a + resp_b):
        row = reframe_decoded_row(FAST, c.decode_response(r))
        payload = bz2.BZ2Decompressor().decompress(row)
        assert extract_result("pipe-key", payload) == b"pipe-value"


def test_read_coalescer_merges_concurrent_requests():
    """Requests that arrive inside the window share one dispatch; a request
    with a bad uuid fails alone; the responses equal the uncoalesced ones."""
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    write(srv, {f"co-{i}": f"value-{i}".encode() for i in range(4)})
    httpd, port = start(srv, window_ms=400.0)
    try:
        api = API("", f"http://localhost:{port}")
        client = Client(FAST)
        uid = api.setup("", client.generate_keys_from_seed(
            b"\x61" * 32, noise_rng=ChaCha20Rng(b"\x62" * 32),
            pp_seed=b"\x63" * 32).serialize(FAST))
        blobs = [uid.encode() + client.generate_query(
            row_from_key(FAST.num_items(), f"co-{i}"),
            noise_rng=ChaCha20Rng(bytes([0x64 + i]) * 32),
            query_seed=bytes([0x74 + i]) * 32).serialize(FAST)
            for i in range(4)]
        bad = b"8" * 36 + blobs[0][36:]
        results: dict = {}

        def reader(name, blob):
            try:
                results[name] = api.private_read("", [blob])[0]
            except ApiError as e:
                results[name] = e.code

        threads = [threading.Thread(target=reader, args=(i, b))
                   for i, b in enumerate(blobs + [bad])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = api._get(f"http://localhost:{port}/metrics")["read_coalescer"]
        assert stats["requests"] == 5 and stats["max_batch"] > 1, stats
        assert stats["batches"] < 5
        assert results[4] == 404
        assert [results[i] for i in range(4)] == srv.private_read_blobs(blobs)
        assert [results[i] for i in range(4)] == [
            srv.private_read_one(b) for b in blobs]
    finally:
        httpd.shutdown()


def test_clear_and_destroy_over_http():
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    httpd, port = start(srv)
    try:
        service = BucketService("", f"http://localhost:{port}")
        bucket = service.connect()
        bucket.write({"gone-soon": b"value"})
        assert bucket.private_read(["gone-soon"]) == [b"value"]
        bucket.clear_entire_bucket()
        assert bucket.private_read(["gone-soon"]) == [None]
        assert bucket.info()["index_layout"] == "compact"
        bucket.destroy_entire_bucket()
        assert srv.destroyed
        for call in (lambda: bucket._api.meta(),
                     lambda: bucket.write({"k": b"v"})):
            with pytest.raises(ApiError) as e:
                call()
            assert e.value.code == 404
    finally:
        httpd.shutdown()


def test_private_read_bytes_equal_the_jax_service():
    """The same writes and the same setup through the JAX service
    (sdk_tpu.server.http) and the port's: the port's /private-read
    responses are the bytes of the JAX package's numpy oracle
    (server_host.process_query) over the rows the JAX service holds, for a
    two-query request body (one batched dispatch), for the port's single
    reads, and for the port's coalesced batch of separate requests. The JAX
    service takes the writes and the setup only: a read there would trace
    its whole batched read program."""
    from sdk_tpu import params as params_j
    from sdk_tpu.kv.write import compress_row as compress_row_j
    from sdk_tpu.server import http as http_j
    from sdk_tpu.server.kv_server import SpiralKvServer

    from test_torch_lifecycle import oracle_db, oracle_read

    jax_srv = SpiralKvServer(params_j.params_from_json(CFG), CFG)
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    jax_httpd = http_j.serve(jax_srv, 0, block=False)
    httpd, port = start(srv, window_ms=300.0)
    try:
        apis = [API("", f"http://localhost:{jax_httpd.server_address[1]}"),
                API("", f"http://localhost:{port}")]
        kv = {f"same-{i}": base64.b64encode(key_to_gold_value(f"same-{i}"))
              .decode() for i in range(5)}
        client = Client(FAST)
        setup = client.generate_keys_from_seed(
            b"\x51" * 32, noise_rng=ChaCha20Rng(b"\x52" * 32),
            pp_seed=b"\x53" * 32).serialize(FAST)
        uid = "4" * 36
        queries = [uid.encode() + client.generate_query(
            row_from_key(FAST.num_items(), k),
            noise_rng=ChaCha20Rng(bytes([0x54 + i]) * 32),
            query_seed=bytes([0x58 + i]) * 32).serialize(FAST)
            for i, k in enumerate(["same-1", "same-4"])]
        for api in apis:
            api.write("", kv)
            api._post(api.endpoint + f"/setup?uuid={uid}", json.dumps(
                base64.b64encode(setup).decode()).encode(), compress=False)
        assert jax_srv.has_uuid(uid)
        db_h = oracle_db(FAST, {i: compress_row_j(r)
                                for i, r in enumerate(jax_srv.rows) if r})
        got = [[oracle_read(FAST, db_h, setup, q) for q in queries],
               apis[1].private_read("", queries)]
        assert got[0] == got[1]
        row = reframe_decoded_row(FAST, client.decode_response(got[1][1]))
        assert extract_result("same-4", bz2.BZ2Decompressor().decompress(
            row)) == key_to_gold_value("same-4")
        # the port alone: single requests, at once (coalesced) and in turn
        singles: dict = {}
        threads = [threading.Thread(
            target=lambda i=i: singles.__setitem__(
                i, apis[1].private_read("", [queries[i]])[0]))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [singles[0], singles[1]] == got[0]
        assert [srv.private_read_one(q) for q in queries] == got[0]
    finally:
        httpd.shutdown()
        jax_httpd.shutdown()


# ---- a real server process (tests/test_e2e_subprocess.py) ----------------

def spawn(tmp_path, *flags):
    """python -m sdk_tpu_torch.server.http 0 params.json --cpu ...; waits
    for "Listening on <port>" and returns (process, port, lines seen)."""
    params_file = tmp_path / "params.json"
    params_file.write_text(CFG)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SDK_TPU_")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdk_tpu_torch.server.http", "0",
         str(params_file), "--cpu", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
        cwd=ROOT)
    seen = []
    deadline = time.time() + 300
    while time.time() < deadline:
        line = proc.stdout.readline()
        seen.append(line)
        if line.startswith("Listening on "):
            return proc, int(line.split()[-1]), seen
        if not line and proc.poll() is not None:
            break
    proc.kill()
    pytest.fail(f"server did not start: {seen}")


def stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()


@pytest.fixture(scope="module")
def server_proc(tmp_path_factory):
    proc, port, _ = spawn(tmp_path_factory.mktemp("cfg"),
                          "--batch-window-ms", "5")
    yield port
    stop(proc)


def test_subprocess_e2e(server_proc):
    bucket = connect_local(server_proc)
    bucket.write({"spawned": b"server works"})
    assert bucket.private_read(["spawned"]) == [b"server works"]


def test_client_resetup_after_server_loses_uuid(server_proc):
    bucket = connect_local(server_proc)
    bucket.write({"resetup-key": b"still here"})
    assert bucket.private_read(["resetup-key"]) == [b"still here"]
    first_uuid = bucket._public_uuid
    bucket._public_uuid = "00000000-0000-4000-8000-000000000000"
    assert bucket.private_read(["resetup-key"]) == [b"still here"]
    assert bucket._public_uuid not in (
        "00000000-0000-4000-8000-000000000000", first_uuid)


def test_async_bucket(server_proc):
    bucket = AsyncBucket(API("", f"http://localhost:{server_proc}"))

    async def run():
        await bucket.async_write({f"async-{i}": f"v{i}".encode()
                                  for i in range(10)})
        return await bucket.async_private_read(["async-3", "async-7"])

    assert asyncio.run(run()) == [b"v3", b"v7"]


def test_restore_warmup_cold_start(tmp_path):
    """Checkpoint a populated bucket, start a server process with --restore
    DIR --warmup, and read."""
    src = SpiralKvServerTorch(FAST, "cpu", CFG)
    write(src, {"ck": b"checkpointed value"})
    ckpt = tmp_path / "ckpt"
    src.save_to_dir(str(ckpt))
    proc, port, seen = spawn(tmp_path, "--restore", str(ckpt), "--warmup")
    try:
        assert any("Restored index" in s for s in seen)
        assert any("Warmup complete" in s for s in seen), \
            "--warmup did not run before the socket opened"
        assert connect_local(port).private_read(["ck"]) \
            == [b"checkpointed value"]
    finally:
        stop(proc)


def test_save_on_exit_sigterm(tmp_path):
    """--save-on-exit checkpoints the index on SIGTERM; a new bucket
    restored from it serves the key."""
    ckpt = tmp_path / "ckpt"
    proc, port, _ = spawn(tmp_path, "--save-on-exit", str(ckpt))
    try:
        connect_local(port).write({"durable": b"survives sigterm"})
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert (ckpt / "state.json").exists(), "SIGTERM did not checkpoint"
    srv = SpiralKvServerTorch(FAST, "cpu", CFG)
    srv.restore_from_dir(str(ckpt))
    assert read_via_protocol(srv, "durable") == b"survives sigterm"


@pytest.mark.parametrize("flags", [("--mesh", "tp=4"),
                                   ("--dense-layout", "throughput")])
def test_unported_serving_flags_refuse(tmp_path, flags):
    """The TPU build's second dense layout is refused by name, and so is a
    mesh spec that names an axis the mesh does not have (a --mesh spec that
    parses is served: tests/test_torch_sharded.py)."""
    (tmp_path / "params.json").write_text(CFG)
    res = subprocess.run(
        [sys.executable, "-m", "sdk_tpu_torch.server.http", "0",
         str(tmp_path / "params.json"), "--cpu", *flags],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    want = "unknown mesh axis" if flags[0] == "--mesh" else "ROADMAP"
    assert res.returncode != 0 and want in res.stderr
    assert "Listening" not in res.stdout
