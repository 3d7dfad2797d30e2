"""DoublePIR checklist service: serve private membership checks over a
bloom-filter bit DB (the reference's password-breach "checklist" deployment;
js/bridge/src/doublepir_lib.rs + bucket.ts:202-232). Ports
sdk_tpu/server/doublepir_server.py; the wire bytes are the same.

The DB is a bloom filter of 2^log2m bits built from the key set; clients
derive k=8 bloom indices per key (SHA-1), batch one DoublePIR query per
index, and declare membership when >= 5 bits decode to 1.

The server computes on the card unless the caller passes ``device="cpu"``,
which runs the plain version of every product.
"""

from __future__ import annotations

import base64
import functools
import json
import threading

import numpy as np
import torch

from ..clients.bloom import bloom_hash
from ..doublepir import scheme
from ..doublepir.database import Db, DbInfo
from ..doublepir.kernels import (as_u32_tensor, device_kernels,
                                 matmul_u32_device)
from ..doublepir.matrix import SEEDS_SHORT
from ..doublepir.params import LOGQ, SEC_PARAM, Params, pick_params
from ..doublepir.serializer import (deserialize_state, deserialize_states,
                                    serialize_state, serialize_states)
from ..doublepir.server_torch import ChecklistServerTorch
from ..ops.shard import check_mesh, mesh_from_cli

BLOOM_K = 8
HINT_CHUNK_BYTES = 4 * 2 ** 20   # hint served in cacheable 4 MiB chunks
                                 # (reference hint-CDN pattern,
                                 #  js/bucket/bucket_service.ts:21-23)


class DoublePirKvServerTorch:
    """Checklist bucket: build a bloom-bit DB from keys, answer batched
    DoublePIR queries.

    The bloom store is a packed bitarray (1 bit per slot, LSB-first) and
    the DB build streams straight from it (Db.from_packed_bits), so the
    production config — 2^30..2^36 bits, reference
    js/bridge/src/doublepir_lib.rs:118-129 — runs with bounded host memory.
    """

    def __init__(self, log2m: int, params: Params | None = None,
                 device="cuda", mesh=None):
        # mesh (ops/shard.Mesh): row-shard the checklist DB over the devices
        # of its "db" axis (ChecklistServerTorch(mesh=)); ``device`` is then
        # the mesh's home device
        self.log2m = log2m
        self.mesh = check_mesh(mesh)
        self.device = mesh.home if mesh is not None else torch.device(device)
        self.num_entries = 1 << log2m
        self.params = params or pick_params(self.num_entries, 1, SEC_PARAM,
                                            LOGQ, lower_bound_m=1)
        self.bit_bytes = np.zeros(max(1, self.num_entries >> 3),
                                  dtype=np.uint8)
        self.keys: set[str] = set()
        self.version = 0
        self.lock = threading.RLock()
        self._matmul = functools.partial(matmul_u32_device,
                                         device=self.device)
        self._kernels = device_kernels(self.device)
        self.db: Db | None = None
        self.db_info: DbInfo | None = None
        self._engine = None      # ChecklistServerTorch when the config allows
        self.server_state: list = []
        self.hint: list = []
        self._hint_bytes: bytes | None = None
        self.shared_state: list | None = None
        self._dirty = True

    def add_keys(self, keys: list[str]) -> None:
        with self.lock:
            idxs = []
            for k in keys:
                self.keys.add(k)
                for i in range(BLOOM_K):
                    idxs.append(bloom_hash(k, i, self.log2m))
            if idxs:
                ia = np.asarray(idxs, dtype=np.int64)
                np.bitwise_or.at(self.bit_bytes, ia >> 3,
                                 (np.uint8(1) << (ia & 7).astype(np.uint8)))
            self.version += 1
            self._dirty = True

    def set_bit(self, idx: int) -> None:
        """Direct bit insert (bulk ingestion path, no key tracking)."""
        with self.lock:
            self.bit_bytes[idx >> 3] |= np.uint8(1 << (idx & 7))
            self._dirty = True

    def _rebuild(self) -> None:
        if not self._dirty:
            return
        self._engine = None
        # byte-element configs (the production checklist: packing=8,
        # ne=x=1) get the fully device-resident server: 1 B/element int8
        # DB, hint + answer products on the device, and NO host-side (l, m)
        # u32 materialization (34 GB at the 2^36-bit config). Any other
        # config is refused with ValueError and takes the general branch.
        try:
            eng = ChecklistServerTorch(self.num_entries, self.params,
                                       self.bit_bytes, device=self.device,
                                       mesh=self.mesh)
        except ValueError:
            eng = None
        if eng is not None:
            if self.shared_state is None and self.mesh is None:
                # production preprocess: the AES-derived A1/A2 stream
                # host->device in chunks and are NEVER materialized on
                # host (760 MB at the checklist shape); A2's upload
                # doubles as its serving residency. Identical matrices
                # (same seeds) and bit-identical hint to the scheme.init
                # path
                self.hint = eng.setup_streamed()
            else:
                if self.shared_state is None:
                    self.shared_state = scheme.init(eng.info, self.params)
                self.hint = eng.setup(self.shared_state)
            self._engine = eng
            self.db_info = eng.info
            self.db = None
        else:
            self.db = Db.from_packed_bits(self.num_entries, self.params,
                                          self.bit_bytes)
            self.db_info = self.db.info
            if self.shared_state is None:
                self.shared_state = scheme.init(self.db.info, self.params)
            self.server_state, self.hint = scheme.setup(
                self.db, self.shared_state, self.params, self._matmul)
            # keep the squished DB and H1 device-resident: answer-path
            # matvecs slice them on device instead of re-uploading per
            # request (scheme.answer works on either array type)
            self.db.data = as_u32_tensor(self.db.data, self.device)
            self.server_state[0] = as_u32_tensor(self.server_state[0],
                                                 self.device)
        self._hint_bytes = serialize_state(self.hint)
        self._dirty = False

    def get_hint(self) -> bytes:
        with self.lock:
            self._rebuild()
            return self._hint_bytes

    def hint_meta(self) -> dict:
        with self.lock:
            self._rebuild()
            n = len(self._hint_bytes)
            return {"hint_bytes": n, "hint_chunk_bytes": HINT_CHUNK_BYTES,
                    "hint_num_chunks":
                        (n + HINT_CHUNK_BYTES - 1) // HINT_CHUNK_BYTES,
                    "version": self.version}

    def hint_chunk(self, i: int) -> bytes:
        with self.lock:
            self._rebuild()
            start = i * HINT_CHUNK_BYTES
            if start >= len(self._hint_bytes) or i < 0:
                raise KeyError(i)
            return self._hint_bytes[start : start + HINT_CHUNK_BYTES]

    def answer(self, query_bytes: bytes) -> bytes:
        with self.lock:
            self._rebuild()
            queries = deserialize_states(query_bytes)
            if self._engine is not None:
                resp = self._engine.answer(queries)
            else:
                resp = scheme.answer(self.db, queries, self.server_state,
                                     self.params, kernels=self._kernels)
            return serialize_state(resp)

    def save_to_dir(self, path: str) -> None:
        """Checkpoint the checklist: bloom bits, key set, the serialized
        client hint, and (device engine) the squished H1 — restore skips
        the expensive hint-setup matmuls. The reference preprocess->serve
        flow (lib/doublepir/src/bin/preprocess.rs writes the server state
        files the server bin loads)."""
        import os

        os.makedirs(path, exist_ok=True)
        with self.lock:
            self._rebuild()
            np.save(os.path.join(path, "bit_bytes.npy"), self.bit_bytes)
            with open(os.path.join(path, "keys.json"), "w") as f:
                json.dump(sorted(self.keys), f)
            assert self._hint_bytes is not None
            with open(os.path.join(path, "hint.bin"), "wb") as f:
                f.write(self._hint_bytes)
            meta = {"log2m": self.log2m, "version": self.version,
                    "engine": "device" if self._engine is not None
                    else "host"}
            if self._engine is not None:
                np.save(os.path.join(path, "h1_sq.npy"),
                        np.asarray(self._engine.h1_sq))
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)

    def restore_from_dir(self, path: str) -> None:
        """Load a checkpoint. The bloom bits are the source of truth: if
        the saved hint artifacts don't match this server's engine/mesh
        configuration, the hint is recomputed from the bits on first use
        (never serves stale or mis-shaped state)."""
        import os

        with self.lock:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            if meta["log2m"] != self.log2m:
                raise ValueError(
                    f"checkpoint log2m={meta['log2m']} != {self.log2m}")
            self.bit_bytes = np.load(os.path.join(path, "bit_bytes.npy"))
            with open(os.path.join(path, "keys.json")) as f:
                self.keys = set(json.load(f))
            self.version = meta["version"]
            self._dirty = True      # default: rebuild from bits on demand
            self._engine = None
            self.db = None
            h1_path = os.path.join(path, "h1_sq.npy")
            if meta["engine"] != "device" or not os.path.exists(h1_path):
                return
            try:
                eng = ChecklistServerTorch(self.num_entries, self.params,
                                           self.bit_bytes, device=self.device,
                                           mesh=self.mesh)
                # validate the checkpointed hint BEFORE deriving/streaming
                # A2 (a mismatched h1 would discard that ~380 MB upload)
                h1 = np.load(h1_path)
                cols = -(-self.params.l // 3) if self.mesh is None \
                    else eng.l_pad // 3
                want = (self.params.n * self.params.delta(), cols)
                if h1.shape != want:
                    raise ValueError(f"h1 shape {h1.shape} != {want}")
                if self.shared_state is not None:
                    a2_install = self.shared_state[1]
                elif self.mesh is not None:
                    self.shared_state = scheme.init(eng.info, self.params)
                    a2_install = self.shared_state[1]
                else:
                    # restore path needs only A2 (answer-serving operand):
                    # stream it to device without the host materialization
                    a2_install = eng._stream_derived_to_device(
                        SEEDS_SHORT[1], self.params.l // eng.info.x,
                        self.params.n)
                eng.install_hint(h1, a2_install)
                with open(os.path.join(path, "hint.bin"), "rb") as f:
                    hint_bytes = f.read()
                self.hint = deserialize_state(hint_bytes)[0]
                self._hint_bytes = hint_bytes
                self._engine = eng
                self.db_info = eng.info
                self._dirty = False
            except (ValueError, AssertionError):
                # shape/config mismatch: keep the bits, rebuild on demand
                self._engine = None
                self._dirty = True

    def warmup(self) -> float:
        """Warm the serving path before traffic arrives: hint setup (the
        expensive device products, and on a card the kernels' build) plus
        one synthetic single-query answer through the real wire path (the
        interactive checkInclusion pattern). Returns elapsed seconds."""
        import time as _time

        t0 = _time.monotonic()
        rng = np.random.default_rng(0)
        lp3 = -(-self.params.l // 3) * 3
        mp3 = -(-self.params.m // 3) * 3
        q = [rng.integers(0, 1 << 32, (mp3, 1), dtype=np.uint64)
             .astype(np.uint32),
             rng.integers(0, 1 << 32, (lp3, 1), dtype=np.uint64)
             .astype(np.uint32)]
        self.get_hint()
        self.answer(serialize_states([q]))
        return _time.monotonic() - t0

    def meta(self) -> dict:
        with self.lock:
            self._rebuild()
            return {
                "id": 0,
                "name": "",
                "owner_id": 0,
                "open_access": True,
                "pir_scheme": {
                    "scheme": "doublepir",
                    "params": self.params.to_string(),
                    "dbinfo": self.db_info.to_string(),
                    "num_entries": str(self.num_entries),
                    "bloom_k": BLOOM_K,
                    "bloom_log2m": self.log2m,
                    "hint_bytes": len(self._hint_bytes),
                    "hint_chunk_bytes": HINT_CHUNK_BYTES,
                },
                "global_version": self.version,
            }


def make_doublepir_handler(srv: DoublePirKvServerTorch):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.rstrip("/") or "/"
            if path.endswith("/meta"):
                self._send(200, json.dumps(srv.meta()).encode())
            elif path.endswith("/hint-meta"):
                self._send(200, json.dumps(srv.hint_meta()).encode())
            elif "/hint/chunk/" in path:
                try:
                    i = int(path.rsplit("/", 1)[1])
                    self._send(200, srv.hint_chunk(i),
                               "application/octet-stream")
                except (KeyError, ValueError):
                    self._send(404, b'{"error": "no such hint chunk"}')
            elif path.endswith("/hint"):
                self._send(200, json.dumps(
                    {"hint": base64.b64encode(srv.get_hint()).decode()}).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            path = self.path.rstrip("/")
            try:
                if path.endswith("/write"):
                    keys = json.loads(body)
                    srv.add_keys(list(keys))
                    self._send(200, b'{"status": "done updating"}')
                elif path.endswith("/private-read"):
                    query_strs = json.loads(body)
                    out = [base64.b64encode(
                        srv.answer(base64.b64decode(q))).decode()
                        for q in query_strs]
                    self._send(200, json.dumps(out).encode())
                else:
                    self._send(404, b'{"error": "not found"}')
            except Exception as e:  # noqa: BLE001
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def serve_doublepir(srv: DoublePirKvServerTorch, port: int,
                    block: bool = True):
    import threading as _t
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("localhost", port),
                                make_doublepir_handler(srv))
    if block:
        print(f"Listening on {port}", flush=True)
        httpd.serve_forever()
    else:
        _t.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv: list[str]) -> None:
    """python -m sdk_tpu_torch.server.doublepir_server <port> <log2m>
           [--cpu] [--mesh SPEC] [--keys-file path] [--warmup]
           [--restore DIR] [--save DIR]

    Serve a checklist (private membership) bucket over HTTP. The DB, the
    hint and the answer products live on the card (ChecklistServerTorch);
    --cpu runs the plain PyTorch versions on the CPU instead. --device is
    accepted and means the default. --mesh SPEC (ops/shard.mesh_from_spec:
    "4", "db=4", "dp=1,db=4") row-shards the DB over that many cards; with
    --cpu over as many logical CPU shards."""
    import sys

    args, device, keys_file, mesh_spec = [], "cuda", None, ""
    warmup, restore_dir, save_dir = False, None, None
    i = 0
    while i < len(argv):
        if argv[i] == "--device":
            pass
        elif argv[i] == "--cpu":
            device = "cpu"
        elif argv[i] == "--mesh":
            mesh_spec = argv[i + 1]
            i += 1
        elif argv[i] == "--keys-file":
            keys_file = argv[i + 1]
            i += 1
        elif argv[i] == "--warmup":
            warmup = True
        elif argv[i] == "--restore":
            restore_dir = argv[i + 1]
            i += 1
        elif argv[i] == "--save":
            save_dir = argv[i + 1]
            i += 1
        else:
            args.append(argv[i])
        i += 1
    if len(args) != 2:
        print(main.__doc__, file=sys.stderr)
        raise SystemExit(2)
    port, log2m = int(args[0]), int(args[1])
    mesh = mesh_from_cli(mesh_spec, device == "cpu") if mesh_spec else None
    srv = DoublePirKvServerTorch(log2m, device=device, mesh=mesh)
    if restore_dir:
        srv.restore_from_dir(restore_dir)
        print(f"Restored checklist from {restore_dir}", flush=True)
    if keys_file:
        with open(keys_file) as f:
            srv.add_keys([ln.strip() for ln in f if ln.strip()])
    if save_dir:
        srv.save_to_dir(save_dir)
        print(f"Saved checklist to {save_dir}", flush=True)
    if warmup:
        dt = srv.warmup()
        print(f"Warmup complete ({dt:.1f}s)", flush=True)
    serve_doublepir(srv, port)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
