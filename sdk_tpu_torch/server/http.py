"""HTTP front end: the reference server's six routes on stdlib http.server
(reference lib/server/src/bin/server.rs:31-187).

Routes:
    GET  /              hello
    GET  /meta          bucket metadata incl. pir_scheme params + version
    GET  /metrics       stages: count, total, mean and last us of each span
                        of the served path (sdk_tpu_torch.telemetry);
                        read_coalescer: batches, requests, max_batch;
                        version, num_rows_populated; index_bytes (the
                        index's device bytes) and cap_bin (compact only)
    POST /setup         store client public params, return {"uuid": ...}
    POST /write         JSON {key: base64 value | null}
    POST /update-row    raw row chunks (u32 len BE | u32 idx BE | bytes)*
    POST /private-read  JSON list of base64 queries -> JSON list of base64
    POST /modify        JSON {"name": ...} — rename the bucket
    POST /destroy       destroy the bucket (subsequent requests 404)

Ports sdk_tpu/server/http.py onto SpiralKvServerTorch: the same routes, the
same read coalescer, the same flags and SDK_TPU_* environment names, plus
--cpu; the device is the CUDA card unless --cpu is given.

Serving config (env or CLI):
    --cpu                             serve from the CPU with the kernels'
                                      plain versions (tests, no card)
    SDK_TPU_MESH / --mesh SPEC        serve from an index cut over a
                                      device mesh (ops/shard.py: "8",
                                      "db=8", "dp=2,db=4"); with --cpu
                                      over logical CPU shards
    SDK_TPU_DENSE_LAYOUT=throughput / --dense-layout throughput
                                      refused: the TPU build's second dense
                                      layout is not ported (ROADMAP.md)
    SDK_TPU_BATCH_WINDOW_MS / --batch-window-ms N
        coalesce /private-read requests arriving within N ms into one
        batched DB scan, fold and pack (cross-request batching; default
        0 = off)
    SDK_TPU_WARMUP / --warmup
        run one synthetic protocol round at startup so the first real
        query doesn't pay the kernels' build; it runs the CURRENT index
        state, so pair it with --restore
    SDK_TPU_RESTORE / --restore DIR
        load a checkpointed index (SpiralKvServerTorch.save_to_dir) before
        serving
    SDK_TPU_SAVE_ON_EXIT / --save-on-exit DIR
        checkpoint the index to DIR on SIGTERM/SIGINT, then exit

Usage: python -m sdk_tpu_torch.server.http <port> [params.json | num_items_log2 item_size]
"""

from __future__ import annotations

import gzip
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..ops.shard import mesh_from_cli
from ..params import params_from_json
from ..telemetry import GLOBAL_TIMERS
from .kv_server import SpiralKvServerTorch


class ReadCoalescer:
    """Cross-request batching window for /private-read.

    Requests arriving within `window_s` of the first are merged into ONE
    `dispatch_queries_batched` call (one DB scan with 2*NQ columns, one
    fold launch per round and one pack launch for the whole batch), so
    concurrent independent clients get the batched aggregate throughput the
    engine already provides within a single request body. Parse failures
    (bad uuid, truncated query) stay per-request.

    Successive windows PIPELINE on the device: leadership for window N+1
    is released before window N's dispatch, and N's blocking fetch runs
    outside every lock, so N+1's dispatch overlaps N's device run +
    response transfer (see kv_server.dispatch_read_blobs).

    Traced (telemetry): each window's leader opens a trace for its
    dispatch; its sleep is the span ``coalescer.window`` and its work on
    the batch after it ``coalescer.batch`` (count: the requests), and a
    follower's wait ``coalescer.wait``, all three in the dispatch's trace,
    which links each request to the dispatch that served it.
    """

    def __init__(self, srv: SpiralKvServerTorch, window_s: float):
        self.srv = srv
        self.window_s = window_s
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._leader_active = False
        self.stats = {"batches": 0, "requests": 0, "max_batch": 0}
        self._trace = 0

    def read_blobs(self, blobs: list[bytes]) -> list[bytes]:
        if self.window_s <= 0:
            return self.srv.private_read_blobs(blobs)
        entry = {"blobs": blobs, "ev": threading.Event(),
                 "res": None, "exc": None}
        with self._lock:
            self._pending.append(entry)
            is_leader = not self._leader_active
            if is_leader:
                self._leader_active = True
                self._trace = GLOBAL_TIMERS.new_trace()
            trace = self._trace
        if not is_leader:
            with GLOBAL_TIMERS.span("coalescer.wait", trace=trace):
                entry["ev"].wait()
            if entry["exc"] is not None:
                raise entry["exc"]
            return entry["res"]

        with GLOBAL_TIMERS.span("coalescer.window", trace=trace):
            time.sleep(self.window_s)
        with self._lock:
            batch = self._pending
            self._pending = []
            self._leader_active = False
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
        with GLOBAL_TIMERS.span("coalescer.batch", len(batch), trace):
            self._run_batch(batch, entry)
        if entry["exc"] is not None:
            raise entry["exc"]
        return entry["res"]

    def _run_batch(self, batch: list[dict], entry: dict) -> None:
        """The leader's dispatch of a window's batch: each entry gets its
        results or its exception, and every follower is woken."""
        srv = self.srv
        try:
            # dispatch under the lock (a concurrent flush writes the index
            # in place, so it must be enqueued before or after the whole
            # batch), but BLOCK on the device transfer outside it so writes
            # and other reads proceed while the device crunches the batch
            fetch = None
            with srv._read_lock():
                srv._flush()
                parsed, slots = [], []
                for e in batch:
                    try:
                        reqs = srv._parse_requests(e["blobs"])
                    except Exception as ex:  # noqa: BLE001 — per-request
                        e["exc"] = ex
                        continue
                    slots.append((e, len(parsed), len(reqs)))
                    parsed.extend(reqs)
                if parsed:
                    try:
                        fetch = srv.engine.dispatch_queries_batched(parsed)
                    except Exception as ex:  # noqa: BLE001
                        for e, _, _ in slots:
                            e["exc"] = ex
            if fetch is not None:
                try:
                    results = fetch()
                    for e, off, n in slots:
                        e["res"] = results[off : off + n]
                except Exception as ex:  # noqa: BLE001
                    for e, _, _ in slots:
                        if e["exc"] is None:
                            e["exc"] = ex
        except BaseException as ex:  # never leave followers hanging
            for e in batch:
                if e["res"] is None and e["exc"] is None:
                    e["exc"] = ex
            raise
        finally:
            for e in batch:
                if e is not entry:
                    e["ev"].set()

    def read_body(self, body: bytes) -> bytes:
        import base64

        query_strs = json.loads(body)
        results = self.read_blobs([base64.b64decode(qs) for qs in query_strs])
        return json.dumps(
            [base64.b64encode(r).decode() for r in results]).encode()


def parse_multipart_file(content_type: str, body: bytes) -> bytes:
    """Extract the 'file' field from a multipart/form-data body (the shape
    postFormData sends to a presigned URL, reference js/client/api.ts:150-178)."""
    for piece in content_type.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"').encode()
            break
    else:
        raise ValueError("multipart body without boundary")
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        if b'name="file"' in head:
            return payload.removesuffix(b"\r\n")
    raise ValueError("multipart body has no 'file' field")


class KvRoutes:
    """Adapts (SpiralKvServerTorch, ReadCoalescer) to the route interface served
    by make_routes_handler (a duck-typed surface, so another back end can
    share the handler)."""

    def __init__(self, srv: SpiralKvServerTorch, reader: ReadCoalescer):
        self.srv = srv
        self.reader = reader
        self.params = srv.params

    @property
    def destroyed(self) -> bool:
        return self.srv.destroyed

    def meta(self) -> dict:
        return self.srv.meta()

    def metrics(self) -> dict:
        m = self.srv.metrics()
        m["read_coalescer"] = self.reader.stats
        return m

    def has_uuid(self, uid: str) -> bool:
        return self.srv.has_uuid(uid)

    def bloom_bytes(self) -> bytes:
        return self.srv.bloom_bytes()

    def list_keys(self) -> list[str]:
        return self.srv.list_keys()

    def setup(self, body: bytes) -> str:
        return self.srv.setup(body)

    def setup_raw(self, raw: bytes, uid: str) -> str:
        return self.srv.setup_raw(raw, uid=uid)

    def write_kv(self, body: bytes) -> dict:
        return self.srv.write_kv(body)

    def update_many_items(self, body: bytes) -> int:
        return self.srv.update_many_items(body)

    def private_read_body(self, body: bytes) -> bytes:
        return self.reader.read_body(body)

    def clear(self) -> None:
        self.srv.clear()

    def rename(self, new_name: str) -> None:
        self.srv.rename(new_name)

    def destroy(self) -> None:
        self.srv.destroy()


def make_routes_handler(iface):
    """The reference server's route surface over any object implementing the
    KvRoutes interface (reference lib/server/src/bin/server.rs:31-187)."""
    # presigned-upload emulation (reference api.rs:149-186): prelim /setup
    # with {"length": N} reserves a token; the payload arrives as a
    # multipart POST to /upload/<token>
    pending_uploads: dict[str, dict] = {}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if self.headers.get("Content-Encoding") == "gzip":
                data = gzip.decompress(data)
            return data

        def do_GET(self):
            path = self.path.rstrip("/") or "/"
            if iface.destroyed and path != "/":
                self._send(404, b'{"error": "bucket destroyed"}')
                return
            if path == "/":
                self._send(200, f"Hello {iface.params.poly_len}!".encode(),
                           "text/plain")
            elif path.endswith("/meta"):
                self._send(200, json.dumps(iface.meta()).encode())
            elif path.endswith("/metrics"):
                self._send(200, json.dumps(iface.metrics()).encode())
            elif path.endswith("/check"):
                # /<uuid>/check — does the server hold this client's params
                uid = path.split("/")[1]
                self._send(200, json.dumps(
                    {"found": iface.has_uuid(uid)}).encode())
            elif path.endswith("/bloom"):
                import base64 as _b64
                try:
                    self._send(200, json.dumps(
                        {"bloom": _b64.b64encode(iface.bloom_bytes()).decode()}
                    ).encode())
                except KeyError:
                    self._send(404, b'{"error": "no bloom filter"}')
            elif path.endswith("/list-keys"):
                try:
                    self._send(200, json.dumps(iface.list_keys()).encode())
                except KeyError:
                    self._send(404, b'{"error": "key storage not enabled"}')
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            path, _, qs = self.path.partition("?")
            path = path.rstrip("/")
            if path.endswith("/private-read"):
                # one request, from its body read to its response written
                with GLOBAL_TIMERS.span("http.private_read", 1):
                    self._post(path, qs)
            else:
                self._post(path, qs)

        def _post(self, path: str, qs: str):
            if iface.destroyed:
                self._send(404, b'{"error": "bucket destroyed"}')
                return
            try:
                body = self._body()
                if path.endswith("/setup"):
                    # explicit uuid (internal: DCN front ends register the
                    # same client params on every instance-shard backend)
                    forced_uid = None
                    for kv in qs.split("&"):
                        if kv.startswith("uuid="):
                            forced_uid = kv[5:]
                    prelim = None
                    if len(body) < 1024 and forced_uid is None:
                        try:
                            parsed = json.loads(body)
                            if isinstance(parsed, dict) and "length" in parsed:
                                prelim = parsed
                        except ValueError:
                            pass
                    if prelim is not None:
                        # presigned-upload flow: reserve uuid + upload slot
                        import uuid as _uuid

                        uid = str(_uuid.uuid4())
                        token = _uuid.uuid4().hex
                        pending_uploads[token] = {
                            "uuid": uid, "length": int(prelim["length"])}
                        self._send(200, json.dumps({
                            "uuid": uid, "url": f"/upload/{token}",
                            "fields": {"key": token}}).encode())
                    else:
                        if forced_uid is not None:
                            import base64 as _b64

                            uid = iface.setup_raw(
                                _b64.b64decode(json.loads(body)), forced_uid)
                        else:
                            uid = iface.setup(body)
                        self._send(200, json.dumps({"uuid": uid}).encode())
                elif "/upload/" in path:
                    token = path.rsplit("/", 1)[1]
                    slot = pending_uploads.pop(token, None)
                    if slot is None:
                        self._send(404, b'{"error": "unknown upload token"}')
                        return
                    raw = parse_multipart_file(
                        self.headers.get("Content-Type", ""), body)
                    if len(raw) != slot["length"]:
                        self._send(400, json.dumps(
                            {"error": f"upload length mismatch: got "
                                      f"{len(raw)}, promised {slot['length']}"}
                        ).encode())
                        return
                    iface.setup_raw(raw, slot["uuid"])
                    self._send(200, json.dumps(
                        {"uuid": slot["uuid"]}).encode())
                elif path.endswith("/write"):
                    resp = iface.write_kv(body)
                    self._send(200, json.dumps(resp).encode())
                elif path.endswith("/update-row"):
                    largest = iface.update_many_items(body)
                    self._send(200, json.dumps(
                        {"status": "done updating",
                         "largest_update": largest}).encode())
                elif path.endswith("/private-read"):
                    self._send(200, iface.private_read_body(body))
                elif path.endswith("/clear"):
                    iface.clear()
                    self._send(200, b'{"status": "cleared"}')
                elif path.endswith("/modify"):
                    iface.rename(json.loads(body)["name"])
                    self._send(200, b'{"status": "modified"}')
                elif path.endswith("/destroy"):
                    iface.destroy()
                    self._send(200, b'{"status": "destroyed"}')
                else:
                    self._send(404, b'{"error": "not found"}')
            except KeyError:
                self._send(404, b'{"error": "unknown uuid"}')
            except Exception as e:  # noqa: BLE001 — surface to client
                code = getattr(e, "http_status", 500)
                self._send(code, json.dumps(
                    {"error": str(e),
                     **getattr(e, "http_details", {})}).encode())

    return Handler


def make_handler(srv: SpiralKvServerTorch, coalescer: ReadCoalescer | None = None):
    """Single-node handler: SpiralKvServerTorch + optional read coalescer."""
    reader = coalescer or ReadCoalescer(srv, 0.0)
    return make_routes_handler(KvRoutes(srv, reader))


class BucketHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog for a burst of readers: the
    stdlib's 5 makes the 6th of 16 simultaneous connects wait for its SYN to
    be sent again, a second or more, which no read coalescing wins back."""

    request_queue_size = 128


def serve(srv: SpiralKvServerTorch, port: int, block: bool = True,
          batch_window_ms: float = 0.0):
    coalescer = ReadCoalescer(srv, batch_window_ms / 1000.0)
    httpd = BucketHTTPServer(("localhost", port),
                             make_handler(srv, coalescer))
    if block:
        # the bound port: port 0 asks the system for a free one
        print(f"Listening on {httpd.server_address[1]}", flush=True)
        httpd.serve_forever()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
    return httpd


DEFAULT_CFG = """{
    "n": 2, "nu_1": 9, "nu_2": 5, "p": 256, "q2_bits": 22,
    "t_gsw": 7, "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5,
    "instances": 4, "db_item_size": 32768
}"""


def main(argv: list[str]):
    """CLI: python -m sdk_tpu_torch.server.http <port> [params.json | n_log2
    item_size] [--cpu] [--batch-window-ms N] [--warmup] [--restore DIR]
    [--save-on-exit DIR] [--mesh SPEC] [--dense-layout latency|throughput]

    --mesh SPEC (or SDK_TPU_MESH; ops/shard.mesh_from_spec: "8", "db=8",
    "dp=2,db=4") serves from an index cut over that many cards, dense from
    the start; with --cpu over as many logical CPU shards (at most 8).

    Env knobs: SDK_TPU_BATCH_WINDOW_MS, SDK_TPU_WARMUP, SDK_TPU_RESTORE,
    SDK_TPU_SAVE_ON_EXIT, SDK_TPU_FORCE_CPU (as --cpu), SDK_TPU_MESH;
    SDK_TPU_DENSE_LAYOUT=throughput is refused like its flag;
    SDK_TPU_HBM_BUDGET_BYTES sets the capacity guard's device-memory budget
    (default: the card's free memory) and SDK_TPU_NO_CAPACITY_GUARD=1
    disables the guard (kv_server._device_budget_bytes)."""
    import os

    mesh_spec = os.environ.get("SDK_TPU_MESH", "")
    window_ms = float(os.environ.get("SDK_TPU_BATCH_WINDOW_MS", "0"))
    warmup = bool(os.environ.get("SDK_TPU_WARMUP"))
    restore_dir = os.environ.get("SDK_TPU_RESTORE", "")
    save_dir = os.environ.get("SDK_TPU_SAVE_ON_EXIT", "")
    dense_layout = os.environ.get("SDK_TPU_DENSE_LAYOUT", "latency")
    cpu = bool(os.environ.get("SDK_TPU_FORCE_CPU"))
    args = []
    i = 1
    while i < len(argv):
        if argv[i] == "--mesh":
            mesh_spec = argv[i + 1]
            i += 2
        elif argv[i] == "--batch-window-ms":
            window_ms = float(argv[i + 1])
            i += 2
        elif argv[i] == "--warmup":
            warmup = True
            i += 1
        elif argv[i] == "--cpu":
            cpu = True
            i += 1
        elif argv[i] == "--restore":
            restore_dir = argv[i + 1]
            i += 2
        elif argv[i] == "--save-on-exit":
            save_dir = argv[i + 1]
            i += 2
        elif argv[i] == "--dense-layout":
            dense_layout = argv[i + 1]
            i += 2
        else:
            args.append(argv[i])
            i += 1

    if dense_layout != "latency":
        raise SystemExit(
            f"--dense-layout {dense_layout}: the port keeps one dense layout "
            f"(ROADMAP.md, 'Do not port the TPU layout workarounds')")
    port = int(args[0]) if args else 8008
    if len(args) == 3:
        from ..params_store import get_params_from_store
        params = get_params_from_store(int(args[1]), int(args[2]))
        params_json = None
    elif len(args) == 2:
        with open(args[1]) as f:
            params_json = f.read()
        params = params_from_json(params_json)
    else:
        params_json = DEFAULT_CFG
        params = params_from_json(params_json)

    mesh = mesh_from_cli(mesh_spec, cpu) if mesh_spec else None
    srv =SpiralKvServerTorch(params, "cpu" if cpu else "cuda", params_json,
                              mesh=mesh)
    if restore_dir:
        srv.restore_from_dir(restore_dir)
        print(f"Restored index from {restore_dir}", flush=True)
    if warmup:
        # build the kernels and run the serving path once before accepting
        # traffic, so the first real query doesn't pay for it
        dt = srv.warmup()
        print(f"Warmup complete ({dt:.1f}s)", flush=True)
    if save_dir:
        import signal

        def _save_and_exit(signum, frame):
            with srv.lock:
                srv.save_to_dir(save_dir)
            print(f"Saved index to {save_dir}; exiting", flush=True)
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, _save_and_exit)
        signal.signal(signal.SIGINT, _save_and_exit)
    serve(srv, port, batch_window_ms=window_ms)


if __name__ == "__main__":
    main(sys.argv)


def cli():
    main(sys.argv)
