"""Multi-host DCN serving: shard Spiral `instances` across backend servers
(a copy of sdk_tpu/server/dcn.py for the port; host code, no kernel).

The reference's instances are fully independent until response
concatenation (lib/server/src/server.rs:53-96 iterates instances*trials and
encode packs per-instance blocks back to back, server.rs:101-134). That
makes instance sharding the natural DCN axis (SURVEY §2.8): each backend
host runs an ordinary single-bucket server (sdk_tpu_torch.server.http)
holding 1/N of the instances, on its own card or mesh of cards, and a
stateless-compute front end owns the KV plane and splices per-instance
response segments.

Topology:
    client ── front end (this module: rows, bloom, routing)
                ├── backend 0: instances [0, I/N)      (own chips / host)
                ├── backend 1: instances [I/N, 2I/N)
                └── ...

Data flow:
 - /write: the front end splices + bzip2-compresses full rows (the KV layer
   must see whole rows), zero-pads to instances*n^2*bytes_per_chunk, and
   sends each backend its instance slice as a raw /update-row body.
 - /setup: forwarded to every backend under one front-end-chosen uuid.
 - /private-read: the query blob is fanned out concurrently; each backend
   expands/scans/folds/packs its instance slice; the front end concatenates
   the per-instance byte segments (each is byte-aligned: poly_len=2048
   makes every field group a multiple of 8 bits) and re-pads.

Note the expansion is recomputed per host (unlike the single-node engine
where all instances share one expansion) — the price of zero cross-host
state, as in the reference's chunked DoublePIR e2e (bin/e2e.rs:60-106).

Usage:
  python -m sdk_tpu_torch.server.dcn <port> <params.json> <backend_url>...
  python -m sdk_tpu_torch.server.dcn <port> <params.json> --spawn N [--cpu]
      (spawns N local backend subprocesses, the CI/demo topology; --cpu is
      passed on to them)
"""

from __future__ import annotations

import base64
import json
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from ..arith import log2_ceil
from ..kv.key_value import row_from_key
from ..kv.write import compress_row, unwrap_kv_pairs, update_row
from ..params import Params, params_from_json, params_to_json_obj
from .http import BucketHTTPServer, make_routes_handler


class BackendError(RuntimeError):
    """One or more backends failed a fan-out. The shared HTTP handler maps
    this to a 502 with per-backend diagnostics so the client can tell a
    routing failure from a compute error."""

    http_status = 502

    def __init__(self, failures: dict[str, str]):
        self.failures = failures
        self.http_details = {"failed_backends": failures}
        super().__init__(
            "backend fan-out failed: "
            + "; ".join(f"{u}: {e}" for u, e in failures.items()))


def backend_params_obj(params: Params, num_backends: int) -> dict:
    """The params each backend serves: instances/N of the full config, with
    db_item_size scaled so bytes_per_chunk is unchanged."""
    assert params.instances % num_backends == 0, (
        f"instances {params.instances} not divisible by {num_backends}")
    obj = params_to_json_obj(params)
    obj["instances"] = params.instances // num_backends
    obj["db_item_size"] = params.instances * params.n * params.n * \
        params.bytes_per_chunk() // num_backends
    return obj


def response_segment_bytes(params: Params) -> int:
    """Bit-exact size of one instance's encoded response segment
    (the encode packs q2_bits*n*z + q1_bits*n^2*z bits per instance,
    ops/encode.py); always byte-aligned for poly_len=2048."""
    q1_bits = log2_ceil(4 * params.pt_modulus)
    bits = (params.q2_bits * params.n * params.poly_len
            + q1_bits * params.n * params.n * params.poly_len)
    assert bits % 8 == 0
    return bits // 8


class DcnFrontend:
    """KV plane + instance-shard router over HTTP backends."""

    def __init__(self, params: Params, backend_urls: list[str],
                 params_json: str | None = None,
                 key_storage_policy: str = "bloom",
                 backend_timeout_s: float = 900.0):
        # timeout default is generous: a backend's first read after restart
        # may cold-compile the pipeline (minutes on a small host). Dead
        # backends are still detected instantly via connection-refused.
        self.params = params
        self.params_json = params_json or json.dumps(params_to_json_obj(params))
        self.urls = [u.rstrip("/") for u in backend_urls]
        self.backend_timeout_s = backend_timeout_s
        # raw client public params by uuid, kept so a restarted (stateless)
        # backend can be resynced without a client round trip
        self._setups: dict[str, bytes] = {}
        self.inst_per = params.instances // len(self.urls)
        backend_params_obj(params, len(self.urls))  # validates divisibility
        self.rows: list[bytearray] = [bytearray()
                                      for _ in range(params.num_items())]
        self.name = ""
        self.destroyed = False
        self.version = 0
        self.lock = threading.RLock()
        self.key_storage_policy = key_storage_policy
        self._stored_keys: set[str] = set()
        self._key_bloom = None
        if key_storage_policy in ("bloom", "full"):
            from ..clients.bloom import BloomFilter

            bits = params.db_dim_1 + params.db_dim_2 + 6
            self._key_bloom = BloomFilter.empty(8, bits)
        self._pool = ThreadPoolExecutor(max_workers=max(4, len(self.urls)))

    # --- backend I/O ---

    def _post(self, url: str, path: str, data: bytes) -> bytes:
        req = urllib.request.Request(
            url + path, data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.backend_timeout_s) as r:
            return r.read()

    def _fanout(self, path: str, data: bytes | list[bytes]) -> list[bytes]:
        """POST to every backend concurrently (per-backend body when `data`
        is a list). Waits for ALL backends, then raises BackendError naming
        every failed URL — a single dead host must not mask another's error
        or leave requests in flight."""
        bodies = data if isinstance(data, list) else [data] * len(self.urls)
        futs = [self._pool.submit(self._post, u, path, b)
                for u, b in zip(self.urls, bodies)]
        results, failures = [], {}
        for u, f in zip(self.urls, futs):
            try:
                results.append(f.result())
            except Exception as e:  # noqa: BLE001 — collected per-backend
                results.append(None)
                failures[u] = f"{type(e).__name__}: {e}"
        if failures:
            raise BackendError(failures)
        return results

    # --- writes (front end owns the KV layer; backends get raw slices) ---

    def write_kv(self, body: bytes) -> dict:
        import time as _time

        t0 = _time.time()
        with self.lock:
            kv_pairs = unwrap_kv_pairs(body)
            by_row: dict[int, list] = {}
            for k, v in kv_pairs:
                by_row.setdefault(
                    row_from_key(len(self.rows), k), []).append((k, v))
            for row_id in sorted(by_row):
                for k, v in by_row[row_id]:
                    update_row(self.rows[row_id], k, v)
                    if v and self._key_bloom is not None:
                        self._key_bloom.insert(k)
                    if v and self.key_storage_policy == "full":
                        self._stored_keys.add(k)
                    elif not v:
                        self._stored_keys.discard(k)
                self._send_row(row_id, compress_row(self.rows[row_id]))
            self.version += 1
        return {"status": "done updating",
                "loading_time_us": int((_time.time() - t0) * 1e6)}

    def _send_row(self, db_idx: int, data: bytes) -> None:
        params = self.params
        trials = params.n * params.n
        bpc = params.bytes_per_chunk()
        full = params.instances * trials * bpc
        if len(data) > full:
            raise ValueError(f"row {db_idx} too large: {len(data)} > {full}")
        padded = bytes(data) + bytes(full - len(data))
        seg = self.inst_per * trials * bpc
        bodies = []
        for b in range(len(self.urls)):
            chunk = padded[b * seg:(b + 1) * seg]
            bodies.append((len(chunk) + 4).to_bytes(4, "big")
                          + db_idx.to_bytes(4, "big") + chunk)
        self._fanout("/update-row", bodies)

    def update_item(self, body: bytes) -> None:
        db_idx = int.from_bytes(body[:4], "big")
        if db_idx >= self.params.num_items():
            raise ValueError(f"bad db idx {db_idx}")
        self._send_row(db_idx, body[4:])

    def update_many_items(self, body: bytes) -> int:
        offs, largest = 0, 0
        with self.lock:
            while offs < len(body):
                chunk_len = int.from_bytes(body[offs:offs + 4], "big")
                data = body[offs + 4:offs + 4 + chunk_len]
                largest = max(largest, len(data))
                self.update_item(data)
                offs += 4 + chunk_len
        return largest

    # --- setup / read ---

    def setup(self, body: bytes) -> str:
        import uuid as uuidlib

        uid = str(uuidlib.uuid4())
        self.setup_raw(base64.b64decode(json.loads(body)), uid)
        return uid

    def setup_raw(self, raw: bytes, uid: str) -> str:
        self._fanout(f"/setup?uuid={uid}", json.dumps(
            base64.b64encode(raw).decode()).encode())
        self._setups[uid] = raw
        return uid

    def has_uuid(self, uid: str) -> bool:
        for u in self.urls:
            try:
                req = urllib.request.Request(f"{u}/{uid}/check")
                with urllib.request.urlopen(
                        req, timeout=self.backend_timeout_s) as r:
                    if not json.loads(r.read()).get("found", False):
                        return False
            except Exception:  # noqa: BLE001
                return False
        return True

    def resync(self, backend_index: int) -> None:
        """Re-push all state a (restarted, stateless) backend needs: every
        retained client setup and every populated row's instance slice. The
        front end owns the KV plane, so a backend restart never needs a
        client round trip."""
        url = self.urls[backend_index]
        with self.lock:
            for uid, raw in self._setups.items():
                self._post(url, f"/setup?uuid={uid}", json.dumps(
                    base64.b64encode(raw).decode()).encode())
            for db_idx, row in enumerate(self.rows):
                if row:
                    self._send_row(db_idx, compress_row(row))

    def private_read_body(self, body: bytes) -> bytes:
        """Fan the query batch out; splice per-instance response segments."""
        params = self.params
        results = self._fanout("/private-read", body)
        lists = [json.loads(r) for r in results]
        nq = len(lists[0])
        seg = response_segment_bytes(params)
        valid_per_backend = self.inst_per * seg
        total_bits = params.instances * seg * 8
        full_bytes = ((total_bits + 63) // 64) * 8
        out = []
        for i in range(nq):
            parts = [base64.b64decode(lst[i])[:valid_per_backend]
                     for lst in lists]
            joined = b"".join(parts)
            joined += bytes(full_bytes - len(joined))
            out.append(base64.b64encode(joined).decode())
        return json.dumps(out).encode()

    # --- admin / metadata ---

    def clear(self) -> None:
        with self.lock:
            for r in self.rows:
                r.clear()
            self._stored_keys.clear()
            if self._key_bloom is not None:
                from ..clients.bloom import BloomFilter

                self._key_bloom = BloomFilter.empty(
                    self._key_bloom.k, self._key_bloom.bits)
            self._fanout("/clear", b"{}")
            self.version += 1

    def destroy(self) -> None:
        with self.lock:
            self.clear()
            self._fanout("/destroy", b"")
            self.destroyed = True

    def rename(self, new_name: str) -> None:
        self.name = new_name

    def bloom_bytes(self) -> bytes:
        if self._key_bloom is None:
            raise KeyError("bloom")
        return self._key_bloom.to_bytes()

    def list_keys(self) -> list[str]:
        if self.key_storage_policy != "full":
            raise KeyError("list-keys")
        return sorted(self._stored_keys)

    def meta(self) -> dict:
        return {
            "id": 0,
            "name": self.name,
            "owner_id": 0,
            "open_access": True,
            "pir_scheme": json.loads(self.params_json),
            "global_version": self.version,
            "dcn_backends": len(self.urls),
        }

    def metrics(self) -> dict:
        return {"version": self.version,
                "num_rows_populated": sum(1 for r in self.rows if r),
                "backends": self.urls}

    # --- checkpoint: the front end owns the deployment's ONLY durable
    # state (backends are stateless — resync pushes them everything) ---

    def save_to_dir(self, path: str) -> None:
        import bz2 as _bz2
        import os
        import struct

        os.makedirs(path, exist_ok=True)
        with self.lock:
            blob = bytearray()
            for row in self.rows:
                blob += struct.pack("<I", len(row)) + row
            with open(os.path.join(path, "rows.bin.bz2"), "wb") as f:
                f.write(_bz2.compress(bytes(blob)))
            meta = {
                "version": self.version,
                "name": self.name,
                "num_rows": len(self.rows),
                "key_storage_policy": self.key_storage_policy,
                "stored_keys": sorted(self._stored_keys),
                "setups": {u: base64.b64encode(r).decode()
                           for u, r in self._setups.items()},
            }
            if self._key_bloom is not None:
                with open(os.path.join(path, "bloom.bin"), "wb") as f:
                    f.write(self._key_bloom.to_bytes())
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)

    def restore_from_dir(self, path: str) -> None:
        """Load a checkpoint, then resync every backend from it — a full
        cold restart of the deployment needs no client round trips."""
        import bz2 as _bz2
        import os
        import struct

        with self.lock:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            if meta["num_rows"] != len(self.rows):
                raise ValueError(
                    f"checkpoint rows {meta['num_rows']} != config "
                    f"{len(self.rows)}")
            with open(os.path.join(path, "rows.bin.bz2"), "rb") as f:
                blob = _bz2.decompress(f.read())
            offs = 0
            for i in range(len(self.rows)):
                (n,) = struct.unpack_from("<I", blob, offs)
                offs += 4
                self.rows[i] = bytearray(blob[offs : offs + n])
                offs += n
            self.version = meta["version"]
            self.name = meta["name"]
            self.key_storage_policy = meta["key_storage_policy"]
            self._stored_keys = set(meta["stored_keys"])
            self._setups = {u: base64.b64decode(r)
                            for u, r in meta["setups"].items()}
            bloom_path = os.path.join(path, "bloom.bin")
            if os.path.exists(bloom_path):
                from ..clients.bloom import BloomFilter

                with open(bloom_path, "rb") as f:
                    self._key_bloom = BloomFilter.from_bytes(f.read())
            for i in range(len(self.urls)):
                self.resync(i)


def make_handler(fe: DcnFrontend):
    """Same route surface as sdk_tpu_torch.server.http (one shared handler
    factory over the duck-typed route interface: no duplicated routes)."""
    return make_routes_handler(fe)


def serve(fe: DcnFrontend, port: int, block: bool = True):
    httpd = BucketHTTPServer(("localhost", port), make_handler(fe))
    if block:
        # the bound port: port 0 asks the system for a free one
        print(f"Listening on {httpd.server_address[1]}", flush=True)
        httpd.serve_forever()
    else:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def spawn_backends(params: Params, n: int, base_port: int,
                   env_extra: dict | None = None, cpu: bool = False):
    """Spawn n local backend subprocesses (the CI/demo topology; production
    points at remote hosts instead), on the CPU with ``cpu``. Returns (urls,
    procs)."""
    import os
    import subprocess
    import tempfile
    import time

    obj = backend_params_obj(params, n)
    f = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
    json.dump(obj, f)
    f.close()
    urls, procs = [], []
    for b in range(n):
        port = base_port + b
        env = dict(os.environ)
        env.update(env_extra or {})
        proc = subprocess.Popen(
            [sys.executable, "-m", "sdk_tpu_torch.server.http", str(port),
             f.name] + (["--cpu"] if cpu else []),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        procs.append(proc)
        urls.append(f"http://localhost:{port}")
    for proc in procs:
        deadline = time.time() + 600
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "Listening on" in line:
                break
        else:
            raise RuntimeError("backend did not start")
    return urls, procs


def main(argv: list[str]):
    import os

    cpu = bool(os.environ.get("SDK_TPU_FORCE_CPU"))
    if "--cpu" in argv:
        argv = [a for a in argv if a != "--cpu"]
        cpu = True
    port = int(argv[1])
    with open(argv[2]) as fjson:
        params_json = fjson.read()
    params = params_from_json(params_json)
    rest, restore_dir = [], None
    i = 3
    while i < len(argv):
        if argv[i] == "--restore":
            restore_dir = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    if rest and rest[0] == "--spawn":
        n = int(rest[1])
        urls, _procs = spawn_backends(params, n, port + 1, cpu=cpu)
        print(f"Spawned {n} backends: {urls}", flush=True)
    else:
        urls = rest
    fe = DcnFrontend(params, urls, params_json)
    if restore_dir:
        fe.restore_from_dir(restore_dir)
        print(f"Restored KV plane from {restore_dir}; backends resynced",
              flush=True)
    serve(fe, port)


if __name__ == "__main__":
    main(sys.argv)
