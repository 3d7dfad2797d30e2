"""The service under test, in the run's own process: the port's bucket
(``SpiralKvServerTorch``) filled through its write path, warmed on the
cell's batch shapes, behind the port's HTTP service.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import torch

from sdk_tpu_torch.params import params_from_json_obj
from sdk_tpu_torch.server.http import serve
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

from ..reference.client import Client
from ..reference.params import params_from_json_obj as reference_params
from ..reference.rng import ChaCha20Rng
from .traffic import Traffic, derive_seed


def row_bytes(params_obj: dict) -> int:
    p = reference_params(params_obj)
    return p.instances * p.n * p.n * p.bytes_per_chunk()


def fill(srv, params_obj: dict, seed: int, device, flush_every: int,
         keep: set[int]) -> dict:
    """Write every row, made from the seed on the device in chunks of
    ``flush_every`` rows, through ``update_item_raw`` and a ``flush`` a
    chunk (the device ingest). Returns the host bytes of the rows in
    ``keep`` and the layout after each flush."""
    n_items = 1 << (int(params_obj["nu_1"]) + int(params_obj["nu_2"]))
    width = row_bytes(params_obj)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kept, layouts = {}, []
    for start in range(0, n_items, flush_every):
        count = min(flush_every, n_items - start)
        chunk = torch.randint(0, 256, (count, width), dtype=torch.uint8,
                              device=device, generator=gen).cpu().numpy()
        for i in range(count):
            data = chunk[i].tobytes()
            srv.update_item_raw(start + i, data)
            if start + i in keep:
                kept[start + i] = data
        srv.flush()
        layouts.append(srv.meta()["index_layout"])
    return {"rows": kept, "layouts": layouts}


def warm(srv, params_obj: dict, seed: int, batch_sizes: list[int]) -> None:
    """Run the engine on each batch size the cell's traffic makes, largest
    first, through the bucket's read path, with one session of the frozen
    client; the session is dropped afterwards."""
    params = reference_params(params_obj)
    client = Client(params)
    pp = client.generate_keys_from_seed(
        derive_seed(seed, "warm-secret"),
        noise_rng=ChaCha20Rng(derive_seed(seed, "warm-noise")),
        pp_seed=derive_seed(seed, "warm-public"))
    uid = srv.setup_raw(pp.serialize(params))
    top = max(batch_sizes)
    blobs = [uid.encode() + client.generate_query(
        (97 * i) % params.num_items(),
        noise_rng=ChaCha20Rng(derive_seed(seed, "warm-q-noise", i)),
        query_seed=derive_seed(seed, "warm-query", i)).serialize(params)
        for i in range(min(top, 8))]
    for nq in sorted(set(batch_sizes), reverse=True):
        srv.private_read_blobs((blobs * nq)[:nq])
    with srv.lock:
        srv.pub_params.pop(uid, None)


def batch_sizes(traffic: Traffic, window_ms: float) -> list[int]:
    """The dispatch sizes a cell's traffic makes: one request's keys with no
    window; with one, any number of whole requests, up to one a session
    (all of a closed loop's clients; an open loop below its knee keeps
    fewer in flight); the engine pads a batch to a power of two, so those
    and the largest."""
    k = traffic.keys_per_request
    if window_ms <= 0:
        return [k]
    top = k * traffic.clients
    sizes, n = {top}, 1
    while n < top:
        if n >= k:
            sizes.add(n)
        n *= 2
    return sorted(sizes | {k})


class DispatchSpans:
    """The host span of every call into the engine's batched dispatch and
    of its fetch, with the batch's query count: (t0, t1, nq, fetch t0,
    fetch t1) in time.monotonic() seconds. Installed on the engine object
    of a traced run only; the program is not changed.

    ``hold`` brings the dispatches onto the calling thread for a while: a
    handler thread hands its dispatch over and waits (dispatches run one at
    a time anyway, under the bucket's lock). torch.profiler records the
    device work of the thread that starts it, and must be started on the
    thread that loaded it, so the run's main thread profiles while it holds
    the dispatches. The fetches stay in the handler threads."""

    def __init__(self, engine):
        self.records: list[list] = []
        self._lock = threading.Lock()
        self._tasks: queue.Queue = queue.Queue()
        self._held = False
        inner = engine.dispatch_queries_batched

        def run(requests):
            t0 = time.monotonic()
            fetch = inner(requests)
            rec = [t0, time.monotonic(), len(requests), None, None]
            with self._lock:
                self.records.append(rec)
            return rec, fetch

        def dispatch(requests):
            fut = None
            with self._lock:
                if self._held:
                    fut = Future()
                    self._tasks.put((run, requests, fut))
            rec, fetch = fut.result() if fut is not None else run(requests)

            def timed_fetch():
                rec[3] = time.monotonic()
                out = fetch()
                rec[4] = time.monotonic()
                return out
            return timed_fetch

        engine.dispatch_queries_batched = dispatch

    def hold(self, seconds: float, begin, end) -> tuple:
        """Run the dispatches on this thread for ``seconds``, ``begin()``
        before them and ``end()`` after; returns both results."""
        with self._lock:
            self._held = True
        a = begin()
        deadline = time.monotonic() + seconds
        while (left := deadline - time.monotonic()) > 0:
            self._run_one(left)
        b = end()
        with self._lock:
            self._held = False
        while not self._tasks.empty():
            self._run_one(0.0)
        return a, b

    def _run_one(self, timeout: float) -> None:
        try:
            fn, arg, fut = self._tasks.get(timeout=timeout) if timeout > 0 \
                else self._tasks.get_nowait()
        except queue.Empty:
            return
        try:
            fut.set_result(fn(arg))
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            fut.set_exception(e)

    def snapshot(self) -> list[list]:
        with self._lock:
            return [list(r) for r in self.records]


def start(cfg: dict, params_obj: dict, device, seed: int, keep: set[int],
          sizes: list[int], fault=None):
    """Build, fill and warm the bucket and start its HTTP service on a free
    port. Returns (bucket, http server, port, kept rows, fill log)."""
    srv = SpiralKvServerTorch(params_from_json_obj(params_obj), device=device)
    if fault is not None:
        fault.before_fill(srv)
    filled = fill(srv, params_obj, seed, device, cfg["fill"]["flush_every"],
                  keep)
    meta = srv.meta()
    if meta["index_layout"] != "dense" or meta["sparse_expansion"]:
        raise RuntimeError(f"bucket after the fill: {meta['index_layout']}, "
                           f"sparse expansion {meta['sparse_expansion']}; "
                           f"want dense, none")
    if fault is not None:
        fault.after_fill(srv)
    warm(srv, params_obj, seed, sizes)
    httpd = serve(srv, 0, block=False,
                  batch_window_ms=float(cfg["batch_window_ms"]))
    return srv, httpd, httpd.server_address[1], filled
