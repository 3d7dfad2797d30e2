"""HTTP load test of the port's bucket service: M concurrent clients
hammering /private-read.

The counterpart of tools/load_test.py for sdk_tpu_torch: it spawns, warms,
loads and stops ``python -m sdk_tpu_torch.server.http``, or loads a server
already running. It exercises the whole serving stack under concurrency:
ThreadingHTTPServer, the ReadCoalescer's pipelined windows
(sdk_tpu_torch/server/http.py), the two-phase dispatch/fetch split, and
reads racing flushing writes, with decode verification on every response.

Each client thread owns a real Bucket (its own keys, its own /setup),
loops `private_read` on randomly chosen seeded keys until the deadline,
and byte-verifies every decode against the deterministic gold value. An
optional writer thread interleaves /write traffic on a disjoint key range,
so that index flushes (kernel H on the card) race the reads.

Usage:
    # spawn a local server on the CPU (tiny params) and load it
    python tools/load_test_torch.py --cpu --clients 8 --duration 10

    # spawn one on the card from a checkpoint of the 1 GiB bucket
    python tools/load_test_torch.py --store 15 32768 --restore DIR \
        --window-ms 25 --clients 16 --duration 10 --writer

    # target an already-running server
    python tools/load_test_torch.py --endpoint http://localhost:8008 \
        --clients 16 --duration 30

A spawned server runs on the CUDA card unless --cpu is given. Prints one
JSON summary line: qps, latency percentiles, error count, the server's
read_coalescer stats (the mean coalesced batch size shows whether
concurrency batched), and client_ms, the medians of a read's parts on the
client (query generation, the session /check, the /private-read round
trip, decode), which say whether the clients or the server set the pace.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SPAWN_TIMEOUT_S = 600.0
# the parts of a read that client_ms times, in the order a read runs them
CLIENT_PARTS = ("query_gen", "check", "http", "decode")


def key_to_gold_value(key: str, size: int = 64) -> bytes:
    """Deterministic key -> value (same scheme as test_live_service.py)."""
    out = bytearray()
    cur = key.encode()
    while len(out) < size:
        cur = hashlib.sha256(cur).digest()
        out.extend(cur)
    return bytes(out[:size])


def server_command(window_ms: float, cpu: bool, params_args: list[str],
                   warmup: bool, restore: str | None) -> list[str]:
    """The spawned server's command line: port 0, so that it binds a free
    port and names it in its "Listening on <port>" line."""
    cmd = [sys.executable, "-m", "sdk_tpu_torch.server.http", "0",
           *params_args, "--batch-window-ms", str(window_ms)]
    if cpu:
        cmd.append("--cpu")
    if restore:
        cmd += ["--restore", restore]
    if warmup:
        cmd.append("--warmup")
    return cmd


def spawn_server(window_ms: float, cpu: bool, params_file: str | None = None,
                 warmup: bool = True, restore: str | None = None,
                 store: tuple[int, int] | None = None
                 ) -> tuple[subprocess.Popen, int]:
    """Spawn python -m sdk_tpu_torch.server.http and wait for its
    "Listening on <port>" line; returns the process and the port. The
    server's params: ``store`` (n_log2, item_size) of the params store, a
    params JSON file, or by default the tiny fast-expansion test params. A
    server that exits or stays silent past SPAWN_TIMEOUT_S is stopped and
    this raises with the end of its stderr."""
    params_args, tmp = [], None
    if store is not None:
        params_args = [str(store[0]), str(store[1])]
    else:
        if params_file is None:
            from sdk_tpu_torch.params import (
                get_fast_expansion_testing_params, params_to_json_obj)

            with tempfile.NamedTemporaryFile(
                    "w", suffix=".json", delete=False,
                    prefix="loadtest_params_") as f:
                json.dump(params_to_json_obj(
                    get_fast_expansion_testing_params()), f)
            params_file = tmp = f.name
        params_args = [params_file]
    err = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        server_command(window_ms, cpu, params_args, warmup, restore),
        stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO)
    port, ready = None, threading.Event()

    def read_stdout():
        nonlocal port
        for line in proc.stdout:         # drained to the end: never blocks
            if port is None and line.startswith("Listening on "):
                port = int(line.split()[2])
                ready.set()
        ready.set()

    threading.Thread(target=read_stdout, daemon=True).start()
    try:
        ready.wait(SPAWN_TIMEOUT_S)
        if port is None:
            stop_server(proc)
            err.seek(0)
            raise RuntimeError(f"server did not start (exit code "
                               f"{proc.returncode}): {err.read()[-3000:]}")
    finally:
        err.close()
        if tmp is not None:          # the server has read it, or is gone
            os.unlink(tmp)
    return proc, port


def stop_server(proc: subprocess.Popen) -> None:
    """SIGTERM, then SIGKILL after 15 s."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def timed_bucket(bucket, parts: dict):
    """Time the parts of bucket.private_read into ``parts`` (seconds added
    to CLIENT_PARTS' keys) by wrapping this Bucket's own methods."""
    def timed(fn, key):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts[key] += time.perf_counter() - t
        return call

    bucket._generate_query = timed(bucket._generate_query, "query_gen")
    bucket._api.check = timed(bucket._api.check, "check")
    bucket._api.private_read = timed(bucket._api.private_read, "http")
    bucket._decode_result_row = timed(bucket._decode_result_row, "decode")
    return bucket


def run_load(endpoint: str, clients: int, duration_s: float,
             keys_per_read: int = 1, n_keys: int = 32,
             writer: bool = False, seed: int = 0) -> dict:
    """Drive `clients` concurrent reader threads for `duration_s`; return
    the summary dict (also usable from tests). Every reader starts its
    first read at the start of the window, so each makes at least one."""
    from sdk_tpu_torch.clients.bucket_service import BucketService

    svc = BucketService("", endpoint)
    seed_bucket = svc.connect("")
    keys = [f"load-{seed}-{i}" for i in range(n_keys)]
    seed_bucket.write({k: key_to_gold_value(k) for k in keys})

    latencies_by_client: list[list[float]] = [[] for _ in range(clients)]
    parts_by_client: list[list[dict]] = [[] for _ in range(clients)]
    errors: list[str] = []
    err_lock = threading.Lock()
    start_barrier = threading.Barrier(clients + (1 if writer else 0) + 1)
    stop = threading.Event()

    def reader(idx: int):
        rng = random.Random(seed * 1000 + idx)
        parts = dict.fromkeys(CLIENT_PARTS, 0.0)
        try:
            b = timed_bucket(BucketService("", endpoint).connect(""), parts)
            b.setup()  # each client its own uuid — the production shape
        except Exception as e:  # noqa: BLE001 — ends the run, see below
            with err_lock:
                errors.append(f"reader{idx} setup: {e!r}")
            start_barrier.abort()
            return
        try:
            start_barrier.wait()
        except threading.BrokenBarrierError:
            return
        lat = latencies_by_client[idx]
        while True:
            batch = rng.sample(keys, keys_per_read)
            parts.update(dict.fromkeys(CLIENT_PARTS, 0.0))
            t0 = time.perf_counter()
            try:
                got = b.private_read(batch)
            except Exception as e:  # noqa: BLE001 — recorded, not fatal
                with err_lock:
                    errors.append(f"reader{idx}: {e!r}")
            else:
                lat.append(time.perf_counter() - t0)
                parts_by_client[idx].append(dict(parts))
                want = [key_to_gold_value(k) for k in batch]
                if got != want:
                    with err_lock:
                        errors.append(f"reader{idx}: decode mismatch on "
                                      f"{batch}")
            if stop.is_set():
                break

    def writer_loop():
        rng = random.Random(seed + 777)
        try:
            start_barrier.wait()
        except threading.BrokenBarrierError:
            return
        i = 0
        while not stop.is_set():
            # churn a disjoint key range so reads stay verifiable while
            # flushes write the device index under the readers
            k = f"churn-{seed}-{rng.randrange(8)}"
            try:
                seed_bucket.write({k: key_to_gold_value(k + str(i))})
            except Exception as e:  # noqa: BLE001
                with err_lock:
                    errors.append(f"writer: {e!r}")
            i += 1
            time.sleep(0.05)

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(clients)]
    if writer:
        threads.append(threading.Thread(target=writer_loop, daemon=True))
    for t in threads:
        t.start()
    try:
        start_barrier.wait()  # everyone set up; the window starts now
    except threading.BrokenBarrierError:
        stop.set()
        raise RuntimeError(f"a client could not set up: {errors[:5]}") \
            from None
    t_start = time.perf_counter()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    elapsed = time.perf_counter() - t_start
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish within 120 s")

    lats = sorted(x for ls in latencies_by_client for x in ls)
    n_reads = len(lats)

    def pct(p: float) -> float:
        return lats[min(n_reads - 1, int(p * n_reads))] if lats else float("nan")

    parts = [p for ps in parts_by_client for p in ps]
    client_ms = {k: float(np.median([p[k] for p in parts])) * 1e3
                 if parts else None for k in CLIENT_PARTS}
    coalescer = {}
    try:
        with urllib.request.urlopen(f"{endpoint}/metrics", timeout=30) as r:
            coalescer = json.load(r).get("read_coalescer", {})
    except Exception:  # noqa: BLE001 — metrics are best-effort
        pass
    return {
        "clients": clients,
        "duration_s": elapsed,
        "reads": n_reads,
        "queries": n_reads * keys_per_read,
        "qps": n_reads * keys_per_read / elapsed if elapsed else 0,
        "latency_ms": {"p50": pct(0.50) * 1e3,
                       "p90": pct(0.90) * 1e3,
                       "p99": pct(0.99) * 1e3},
        "errors": len(errors),
        "error_samples": errors[:5],
        "read_coalescer": coalescer,
        "mean_coalesced_batch": coalescer.get("requests", 0)
        / coalescer["batches"] if coalescer.get("batches") else None,
        "client_ms": client_ms,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--endpoint", default="",
                    help="target an existing server; else spawn one locally")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--keys-per-read", type=int, default=1)
    ap.add_argument("--n-keys", type=int, default=32)
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="coalescer window for the spawned server")
    ap.add_argument("--params-file", default=None,
                    help="params JSON for the spawned server "
                         "(default: tiny fast-expansion test params)")
    ap.add_argument("--store", type=int, nargs=2, default=None,
                    metavar=("N_LOG2", "ITEM_SIZE"),
                    help="the spawned server's params from the params store "
                         "(2^N_LOG2 items of ITEM_SIZE bytes)")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="the spawned server restores this checkpoint")
    ap.add_argument("--writer", action="store_true",
                    help="interleave a background writer (flushes race reads)")
    ap.add_argument("--cpu", action="store_true",
                    help="spawned server runs on the CPU (default: the card)")
    ap.add_argument("--no-warmup", action="store_true")
    args = ap.parse_args(argv)

    proc = None
    endpoint = args.endpoint
    try:
        if not endpoint:
            proc, port = spawn_server(
                args.window_ms, cpu=args.cpu, params_file=args.params_file,
                warmup=not args.no_warmup, restore=args.restore,
                store=args.store)
            endpoint = f"http://localhost:{port}"
            print(f"spawned server at {endpoint}", file=sys.stderr)
        summary = run_load(endpoint, args.clients, args.duration,
                           keys_per_read=args.keys_per_read,
                           n_keys=args.n_keys, writer=args.writer)
        print(json.dumps(summary), flush=True)
        return summary
    finally:
        if proc is not None:
            stop_server(proc)


if __name__ == "__main__":
    main()
