#!/usr/bin/env python3
"""Capture a torch.profiler trace of the port's hot serving path and read
the device's idle share and the host gaps between its hand launches.

The counterpart of tools/profile_trace.py (the JAX package's) for
sdk_tpu_torch: ``sdk_tpu_torch.telemetry.profile_trace`` writes a Chrome /
Perfetto trace (open it in ui.perfetto.dev), and this tool reads it back.

What it traces (pick with --target):
  batch16   a 16-query batch of expansion queries (4 sessions x 4 queries)
            through SpiralKvServerTorch.dispatch_read_blobs on the 1 GiB
            bucket (get_params_from_store(15, 32768), a random 8.59 GB dense
            index: the read's work does not depend on the rows)
  direct    the same with direct-upload params (the 1 GiB bucket's with
            "direct_upload": 1): 4 distinct queries, each carrying its
            public params, sent 4 times each
  scan      the dense scan alone (kernel C, R = 32 columns)

Usage:
    python3 tools/profile_trace_torch.py --out DIR [--target batch16]
        [--iters N]
    # tiny shapes on the CPU (no card, the kernels' plain versions; the
    # fast testing params, or chip_smoke's small direct-upload config, and
    # batches of 4 queries):
    python3 tools/profile_trace_torch.py --out DIR --cpu --tiny

Each traced iteration runs inside a ``read`` span. Per iteration it reports
the window (the span, extended to the end of the last kernel launched in
it), the device's busy time (the union of the kernels' intervals) and idle
share, the copies' time, the hand launches (kernels of
sdk_tpu_torch/csrc), the host time before the first and after the last of
them, and the longest host gaps between two of them (end of one launch
call to the start of the next), each with the device's busy time (kernels
and copies) inside it: a gap the device fills is the host waiting on it,
as a pageable copy does. Prints one JSON line. A profiler session
slows every later launch of its process: run the tool in a process of its
own, after any timing.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 20261018
TOP_GAPS = 5


def hand_kernel_names(csrc: str) -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources (each named
    ``*_kernel``)."""
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        text = open(path).read()
        for m in re.finditer(r"__global__", text):
            k = re.search(r"\b(\w+_kernel)\s*\(", text[m.end():m.end() + 400])
            if k:
                names.add(k.group(1))
    return names


def hand_name(kernel: str, names: set[str]) -> str | None:
    """The hand kernel a trace's kernel name is, or None for PyTorch's."""
    if "at::" in kernel or "cub::" in kernel:
        return None
    for m in re.finditer(r"\b(\w+_kernel)\b", kernel):
        if m.group(1) in names:
            return m.group(1)
    return None


def union_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def analyse(trace: dict, names: set[str], span: str = "read") -> list[dict]:
    """Per ``span`` annotation of a Chrome trace (torch.profiler's
    export): its window, the device's busy time and idle share, the copies'
    time, and the host gaps between the hand launches made inside it. Times
    in ms."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = sorted((e for e in evs if e.get("cat") == "user_annotation"
                    and e.get("name") == span), key=lambda e: e["ts"])
    calls = [e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})]
    device = {e["args"]["correlation"]: e for e in evs
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})}
    out = []
    for sp in spans:
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
        inside = sorted((c for c in calls if t0 <= c["ts"] <= t1),
                        key=lambda c: c["ts"])
        work = [(c, device[c["args"]["correlation"]]) for c in inside
                if c["args"]["correlation"] in device]
        kernels = [(c, d) for c, d in work if d["cat"] == "kernel"]
        copies = [d for _, d in work if d["cat"] != "kernel"]
        end = max([t1] + [d["ts"] + d["dur"] for _, d in work])
        busy = union_us([(d["ts"], d["ts"] + d["dur"]) for _, d in kernels])
        hand = [(c, hand_name(d["name"], names)) for c, d in kernels]
        hand = [(c, n) for c, n in hand if n is not None]
        spans_all = [(d["ts"], d["ts"] + d["dur"]) for _, d in work]

        def busy_in(g0, g1):
            return union_us([(max(a, g0), min(b, g1)) for a, b in spans_all
                             if a < g1 and b > g0])

        gaps = [{"ms": (b["ts"] - a["ts"] - a["dur"]) / 1e3,
                 "device_busy_ms": busy_in(a["ts"] + a["dur"], b["ts"]) / 1e3,
                 "after": na, "before": nb}
                for (a, na), (b, nb) in zip(hand, hand[1:])]
        gaps.sort(key=lambda g: -g["ms"])
        window = end - t0
        out.append({
            "window_ms": window / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else None,
            "idle_share_with_copies":
                1.0 - union_us(spans_all) / window if window > 0 else None,
            "copy_ms": union_us([(d["ts"], d["ts"] + d["dur"])
                                 for d in copies]) / 1e3,
            "kernels": len(kernels),
            "hand_launches": len(hand),
            "hand_launch_order": [n for _, n in hand],
            "host_before_first_launch_ms":
                (hand[0][0]["ts"] - t0) / 1e3 if hand else None,
            "host_after_last_launch_ms":
                (t1 - hand[-1][0]["ts"] - hand[-1][0]["dur"]) / 1e3
                if hand else None,
            "gaps_between_launches_total_ms": sum(g["ms"] for g in gaps),
            "longest_gaps_ms": gaps[:TOP_GAPS]})
    return out


def random_dense_bucket(params, dev, seed: int):
    """A bucket holding a random dense index of its full size."""
    import torch

    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    srv = SpiralKvServerTorch(params, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    srv.engine.db = None
    srv.engine.set_db(torch.randint(0, 128, sj.db_shape(params),
                                    dtype=torch.int8, device=dev,
                                    generator=gen))
    return srv


def read_blobs(srv, params, per_client: int, batch: int) -> list[bytes]:
    """``batch`` request blobs: 4 seeded clients make ``per_client`` queries
    each, repeated to ``batch``; a session's uuid, or for direct-upload
    params the public params, before each query."""
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.rng import ChaCha20Rng

    blobs = []
    for c in range(4):
        client = Client(params)
        setup = client.generate_keys_from_seed(
            bytes([0x30 + c]) * 32, noise_rng=ChaCha20Rng(bytes([0x40 + c]) * 32),
            pp_seed=bytes([0x50 + c]) * 32).serialize(params)
        head = (srv.setup_raw(setup).encode() if params.expand_queries
                else setup)
        for k in range(per_client):
            q = client.generate_query(
                (97 * (c * 4 + k)) % params.num_items(),
                noise_rng=ChaCha20Rng(bytes([0x60 + 4 * c + k]) * 32),
                query_seed=bytes([0x70 + 4 * c + k]) * 32)
            blobs.append(head + q.serialize(params))
    return (blobs * batch)[:batch]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="trace output directory")
    ap.add_argument("--target", default="batch16",
                    choices=["batch16", "direct", "scan"])
    ap.add_argument("--iters", type=int, default=2,
                    help="traced iterations (after one untraced warm-up)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="the fast testing params in place of the 1 GiB "
                         "bucket")
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import record_function

    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                      params_from_json)
    from sdk_tpu_torch.params_store import get_params_from_store
    from sdk_tpu_torch.telemetry import profile_trace

    from chip_smoke import DIRECT_SMALL, direct_params

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("profile_trace_torch: no CUDA device (pass --cpu)")
    dev = torch.device("cpu" if args.cpu else "cuda")
    card = None
    if dev.type == "cuda":
        _build.lib()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    if args.tiny:
        params = (params_from_json(DIRECT_SMALL) if args.target == "direct"
                  else get_fast_expansion_testing_params())
    else:
        params = get_params_from_store(15, 32768)
        if args.target == "direct":
            params = direct_params(params)
    t = time.perf_counter()
    srv = random_dense_bucket(params, dev, SEED)
    if args.target == "scan":
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1)
        cols = torch.randint(0, min(params.moduli),
                             (params.crt_count, params.poly_len,
                              1 << params.db_dim_1, 32), dtype=torch.int32,
                             device=dev, generator=gen)

        def run_once():
            sj.firstdim_multiply(params, srv.engine.db, cols)
    else:
        # direct-upload queries take seconds each to make: 4 distinct; the
        # tiny mode's batch is 4 queries
        blobs = read_blobs(srv, params,
                           1 if args.target == "direct" or args.tiny else 4,
                           4 if args.tiny else 16)

        def run_once():
            resps = srv.dispatch_read_blobs(blobs)()
            if len(resps) != len(blobs) or len({len(r) for r in resps}) != 1:
                raise AssertionError("a batch's responses are malformed")
    setup_s = time.perf_counter() - t
    run_once()                                # warm-up: first launches
    if dev.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    with profile_trace(args.out, cuda=dev.type == "cuda") as prof:
        for _ in range(args.iters):
            with record_function("read"):
                run_once()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v // args.iters for k, v in _build.LAUNCHES.items() if v}
    with open(prof.trace_path) as f:
        reads = analyse(json.load(f), hand_kernel_names(
            os.path.join(REPO, "sdk_tpu_torch", "csrc")))
    summary = {
        "tool": "profile_trace_torch", "target": args.target,
        "device": str(dev), "card": card, "tiny": args.tiny,
        "params": {"nu_1": params.db_dim_1, "nu_2": params.db_dim_2,
                   "instances": params.instances,
                   "direct_upload": not params.expand_queries},
        "trace_dir": os.path.abspath(args.out),
        "trace_file": prof.trace_path, "iters": args.iters,
        "setup_s": setup_s, "traced_wall_s": wall,
        "launches_per_iter": launches, "reads": reads}
    if reads and reads[0]["idle_share"] is not None and dev.type == "cuda":
        summary["idle_share_median"] = float(np.median(
            [r["idle_share"] for r in reads]))
        summary["window_ms_median"] = float(np.median(
            [r["window_ms"] for r in reads]))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
