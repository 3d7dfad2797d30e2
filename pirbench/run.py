#!/usr/bin/env python3
"""The benchmark of sdk_tpu_torch's private reads over HTTP.

    python3 pirbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card; the cell's
configuration, traffic and metrics are found by name through
BENCHMARK.json (pirbench/harness/cells.py). One run, in one process:

1. fails (exit 3, no result) without a CUDA card, or with fewer than the
   cell asks for; logs the card's name, count and power limit;
2. spawns the traffic's load processes (pirbench/harness/load.py), which
   make their clients' keys and queries with the frozen NumPy client
   meanwhile;
3. sets up the port's bucket, SpiralKvServerTorch on the card, writes the
   rows the configuration's fill names (every row, or ``fill.rows`` at
   their keys' hashes: harness/service.py written_rows) from the seed
   through update_item_raw + flush, holds the layout to the configuration's
   ``fill.expect`` (without it: the dense index, no sparse expansion),
   warms the cell's batch shapes and starts sdk_tpu_torch.server.http.serve
   with the configuration's coalescing window; the load processes set up
   their sessions over HTTP and load the service for the traffic's ramp;
4. measures the window of --seconds: every /private-read request completed
   in it, from its send to its whole response;
5. has every answer of the run judged after the window: decoded with its
   client's secret key, it must give the bytes written at its row (zeros
   at a row the fill did not write);
6. prints, as the last line of standard output, the result: ``correct``,
   ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
   (traced runs) and last ``checks``, each number compared beside its
   limit, which also close standard error.

--trace 1 is a run of its own: it times each engine dispatch and its fetch
from here, reads the coalescer's counters from /metrics, and profiles a
slice in the middle of the window with torch.profiler while this process's
main thread makes the dispatches (torch.profiler records the device work
of the thread that starts it, and the service dispatches from its handler
threads); the trace goes to a temporary directory under TMPDIR and is
deleted once read. Its metrics are the cell's per-layer ones.

--cpu-tiny, for the benchmark's own tests only: the port's plain CPU path
at the fast testing parameters, a client a load process, at most two
keys a request and a request a second, no card, no profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, replace

T_PROCESS = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules no run may hold once its window has closed (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdk_tpu")
# the fast testing parameters of --cpu-tiny: 256 rows of 8 KiB
TINY_PARAMS = {"n": 2, "nu_1": 6, "nu_2": 2, "p": 256, "q2_bits": 20,
               "t_gsw": 8, "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8,
               "instances": 1, "db_item_size": 8192}
TRACE_SECONDS = 4.0      # the profiled slice, in the middle of the window
START_LEAD_S = 0.2       # from "go" to the load's start
READY_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(f"[pirbench] {msg}", file=sys.stderr, flush=True)


def card(torch, chips: int) -> dict:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    count = torch.cuda.device_count()
    if count < chips:
        raise NoCard(f"{count} CUDA devices, the cell asks for {chips}")
    name = torch.cuda.get_device_name(0)
    limit = "unknown"
    nvsmi = shutil.which("nvidia-smi")
    if nvsmi:
        limit = subprocess.run(
            [nvsmi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False).stdout.strip()
    log(f"device {name}, {count} visible, nvidia-smi: {limit}")
    return {"platform": "gpu", "kind": name, "count": chips}


class NoCard(RuntimeError):
    pass


def percentile(values, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def get_json(port: int, path: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def coalescer_delta(before: dict, after: dict) -> dict:
    a, b = after["read_coalescer"], before["read_coalescer"]
    return {k: a[k] - b[k] for k in ("batches", "requests")}


def expect(workers, what: str) -> None:
    """Wait for every load process to report ``what``."""
    for i, (_, conn) in enumerate(workers):
        if not conn.poll(READY_TIMEOUT_S):
            raise RuntimeError(f"load process {i}: no '{what}' in time")
        msg = conn.recv()
        if msg[0] != what:
            raise RuntimeError(f"load process {i} failed:\n{msg[1]}")
        log(f"load process {i} {what} in {msg[1]:.2f} s")


def warm_profiler(torch) -> None:
    """Start and stop torch.profiler once over a small device operation, so
    that the profiler's own start-up (CUPTI's) falls into set-up and not
    into the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1024, device="cuda").sum().item()


def profile_slice(spans, seconds: float, out_dir: str) -> tuple:
    """A torch.profiler trace of ``seconds`` of the card's activity, with
    this thread holding the engine's dispatches meanwhile; the slice opens
    and closes with an annotation, each right after a host reading. The
    profiler starts before the dispatches are held and stops after they are
    let go, so that the handler threads keep dispatching while it starts
    and stops. Returns the two host readings."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pirbench.harness.trace import SLICE_END, SLICE_START

    def mark(name: str) -> float:
        t = time.monotonic()
        with record_function(name):
            pass
        return t

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        anchors = spans.hold(seconds, lambda: mark(SLICE_START),
                             lambda: mark(SLICE_END))
    finally:
        prof.stop()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return anchors


def sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, cpu_tiny: bool = False, fault=None) -> dict:
    """One run of a cell; returns the result (without printing it)."""
    import multiprocessing as mp

    import numpy as np
    import torch

    from pirbench.harness import load, service
    from pirbench.harness.cells import load_cell, load_reader
    from pirbench.harness.layers import LayerView, csrc_dir
    from pirbench.harness.trace import TraceView, hand_kernel_names, load_trace
    from pirbench.harness.traffic import plan

    cell = load_cell(root, workload)
    if cpu_tiny:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1}
        dev = torch.device("cpu")
        params = dict(TINY_PARAMS)
        trace = False
    else:
        device_info = card(torch, cell.chips)
        dev = torch.device("cuda:0")
        params = cell.config["params"]
    traffic = cell.traffic
    if cpu_tiny:
        # a client a process, two requests each of at most two keys, at
        # most a request a second: the plain CPU path answers a few queries
        # a second
        traffic = replace(traffic, clients=traffic.processes,
                          pool_per_client=min(traffic.pool_per_client, 2),
                          keys_per_request=min(traffic.keys_per_request, 2),
                          rate_per_s=min(traffic.rate_per_s, 1.0))
    window_ms = float(cell.config["batch_window_ms"])
    written = service.written_rows(cell.config, params, seed)
    procs_plan = plan(traffic, seed, written if traffic.rows == "written"
                      else range(service.n_items(params)))
    keep = {r for clients in procs_plan for c in clients
            for req in c["pool"] for r in req}

    ctx = mp.get_context("spawn")
    workers = []
    httpd = None
    try:
        for i, clients in enumerate(procs_plan):
            parent, child = ctx.Pipe()
            spec = {"params": params, "seed": seed, "process": i,
                    "clients": clients, "traffic": asdict(traffic)}
            p = ctx.Process(target=load.client_process, args=(child, spec),
                            daemon=True)
            p.start()
            child.close()
            workers.append((p, parent))
        t = time.monotonic()
        srv, httpd, port, filled = service.start(
            cell.config, params, dev, seed, written, keep,
            service.batch_sizes(traffic, window_ms), fault)
        log(f"bucket filled ({len(written)} rows) and warmed in "
            f"{time.monotonic() - t:.2f} s, layouts after each flush "
            f"{filled['layouts']}, index {filled['index_bytes']} bytes, "
            f"cap_bin {filled['cap_bin']}, serving on port {port} with a "
            f"{window_ms} ms window")
        spans = service.DispatchSpans(srv.engine) if trace else None
        if trace:
            warm_profiler(torch)
        expect(workers, "keyed")
        # a row the fill did not write reads back as zeros
        blank = bytes(service.row_bytes(params))
        for (p, conn), clients in zip(workers, procs_plan):
            conn.send(("serve", port, {r: filled["rows"].get(r, blank)
                                       for c in clients for req in c["pool"]
                                       for r in req}))
        expect(workers, "ready")
        t_start = time.monotonic() + START_LEAD_S
        t0 = t_start + traffic.ramp_s
        t1 = t0 + seconds
        for _, conn in workers:
            conn.send(("go", t_start, t0, t1))
        sleep_until(t0)
        setup_s = t0 - T_PROCESS
        view = None
        if trace:
            m0 = get_json(port, "/metrics")
            slice_s = min(TRACE_SECONDS, seconds / 2)
            s0 = t0 + (seconds - slice_s) / 2
            sleep_until(s0)
            m1 = get_json(port, "/metrics")
            counted = [r for r in spans.snapshot() if r[0] < s0]
            tmp = tempfile.mkdtemp(prefix="pirbench-trace-")
            try:
                anchors = profile_slice(spans, slice_s, tmp)
                tv = TraceView(load_trace(tmp), anchors, spans.snapshot())
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            log(f"trace anchors {anchors}, skew {tv.anchor_skew_us:.1f} us")
            view = LayerView(coalescer_delta(m0, m1), counted, tv, params,
                             csrc_dir(root))
        sleep_until(t1)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        done = []
        for p, conn in workers:
            if not conn.poll(load.REQUEST_TIMEOUT_S + 200.0):
                raise RuntimeError("a load process did not report")
            msg = conn.recv()
            if msg[0] != "done":
                raise RuntimeError(f"load process failed:\n{msg[1]}")
            done.append(msg[1])
        for p, _ in workers:
            p.join(timeout=30)
    finally:
        for p, conn in workers:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            conn.close()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()

    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        raise ForbiddenModules(f"modules loaded in the run: {held}")

    t_sent = np.concatenate([d["t_sent"] for d in done])
    t_done = np.concatenate([d["t_done"] for d in done])
    keys = np.concatenate([d["keys"] for d in done])
    outcome = np.concatenate([d["outcome"] for d in done])
    for d in done:
        for line in d["wrong"]:
            log(f"wrong: {line}")
    log(f"judged {sum(d['decoded'] for d in done)} distinct bodies in "
        f"{max(d['judge_s'] for d in done):.2f} s")
    if traffic.loop == "open":
        log(f"the open loop's latest send was "
            f"{max(d['max_lag_s'] for d in done):.4f} s after it was due")
    in_win = (t_done >= t0) & (t_done < t1)
    if not in_win.any():
        raise RuntimeError("no request completed in the window")
    right = outcome == load.RIGHT
    lat_ms = (t_done - t_sent)[in_win] * 1e3
    values = {
        "reads_per_s": float(keys[in_win & right].sum()) / seconds,
        "read_p50_ms": percentile(lat_ms, 50),
        "read_p95_ms": percentile(lat_ms, 95),
        "setup_s": setup_s,
    }
    log(f"{int(in_win.sum())} requests completed in the window "
        f"({int(keys[in_win].sum())} reads), {len(outcome)} sent in all")
    log(f"requests answered wrong {int((outcome == load.WRONG).sum())}, "
        f"with an HTTP error {int((outcome == load.HTTP_ERROR).sum())}, "
        f"never answered {int((outcome == load.NO_ANSWER).sum())}, not "
        f"judged {int((outcome == load.UNJUDGED).sum())}")
    # the one number compared: every request of the run must come back
    # with answers that decode to the rows written (an exact comparison)
    checks = {"requests_not_right": (int((~right).sum()), 0)}
    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_reader(root, m["name"])(view)
            if v is None:
                log(f"per-layer metric {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # an end-to-end metric is named by its quantity, split by the cells
        # that report it where they need bounds of their own
        # (reads_per_s.batched)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
        for k, v in values.items():
            log(f"{k} {v}")
    device = dict(device_info, memory_peak_bytes=int(peak))
    result = {"correct": correct, "attempted": int(len(outcome)),
              "failed": int((~right).sum()), "metrics": metrics,
              "device": device}
    if trace:
        tv = view.trace
        device.update(busy_s=tv.busy_us / 1e6, window_s=tv.slice_us / 1e6)
        result["breakdown"] = {
            "device_ops": tv.op_seconds(hand_kernel_names(csrc_dir(root))),
            "idle_gaps": tv.idle_gaps()}
        log(f"slice {tv.slice_us / 1e6} s, {len(tv.dispatches)} dispatches "
            f"in it, device busy {tv.busy_us / 1e6} s")
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-tiny", action="store_true",
                    help="the benchmark's own tests: the plain CPU path at "
                         "the fast testing parameters")
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), cpu_tiny=args.cpu_tiny)
    except NoCard as e:
        log(f"no run: {e}")
        return 3
    except ForbiddenModules as e:
        log(str(e))
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
