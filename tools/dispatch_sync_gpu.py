#!/usr/bin/env python3
"""Where a batched read makes the host wait for the card.

Runs ``SpiralServerTorch.dispatch_queries_batched`` on the card, warm (a
first batch builds the kernels and makes the engine's tables), under
``torch.cuda.set_sync_debug_mode("warn")``, and records every call that
torch reports as synchronizing, with the frames of the package that made
it. Each read path of the engine, small params (the dispatch's calls do not
depend on the index size):

- ``dense``: a dense index and the dense expansion (a restored or migrated
  bucket, the path the HTTP load runs);
- ``compact``: a bucket's compact index and the sparse expansion (a fresh
  bucket with a few rows);
- ``sharded``: a dense index cut over a logical (dp=2, db=4) mesh of the
  card;
- ``direct``: direct-upload queries (the public params inline, no
  expansion); ``direct_parse`` is their request parse, which the read
  coalescer runs under the bucket's lock just before the dispatch.

Each checked batch's responses are held against the same batch's warm
responses (equal bytes). One JSON line a (path, NQ), then a summary line
with each path's distinct sites.

    python3 tools/dispatch_sync_gpu.py [--root DIR] [--nq 1,4]

``--root`` imports the sdk_tpu_torch package of another checkout (a
parent unpacked under build/parent). Needs a CUDA card: exits 1 without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback
import warnings

import numpy as np
import torch

PACKAGE = "sdk_tpu_torch"
DIRECT_SMALL = ('{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
                ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
                ' "t_exp_right": 8}')


def _frame(f) -> str:
    name = f.filename
    cut = name.rfind(PACKAGE + os.sep)
    return f"{name[cut:] if cut >= 0 else os.path.basename(name)}:{f.lineno}"


def sync_sites(fn):
    """fn() under set_sync_debug_mode("warn"): (its result, the
    synchronizing calls it made, each {"where": innermost package frame,
    "stack": the package's frames, outermost first, "message"})."""
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        stack = [_frame(f) for f in traceback.extract_stack()[:-1]
                 if PACKAGE + os.sep in f.filename]
        sites.append({"where": stack[-1] if stack else f"{filename}:{lineno}",
                      "stack": stack, "message": str(message)})

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sites


def sessions(params, count: int, seed: int):
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.rng import ChaCha20Rng

    out = []
    for k in range(count):
        s = seed + 4 * k
        client = Client(params)
        pp = client.generate_keys_from_seed(
            bytes([s]) * 32, noise_rng=ChaCha20Rng(bytes([s + 1]) * 32),
            pp_seed=bytes([s + 2]) * 32)
        out.append((client, pp))
    return out


def queries(params, sess, nq: int, items: list):
    from sdk_tpu_torch.rng import ChaCha20Rng

    return [sess[k % len(sess)][0].generate_query(
        items[k % len(items)], noise_rng=ChaCha20Rng(bytes([0x40 + k]) * 32),
        query_seed=bytes([0x60 + k]) * 32) for k in range(nq)]


def random_dense(params, dev):
    from sdk_tpu_torch.ops import spiral as sj

    gen = torch.Generator(device=dev).manual_seed(19)
    return torch.randint(0, 128, sj.db_shape(params), generator=gen,
                         dtype=torch.int8, device=dev)


def engine_requests(params, engine, nq: int):
    """(the engine's device key dict, query) pairs of two sessions."""
    from sdk_tpu_torch.ops.server import pp_to_device

    sess = sessions(params, 2, 0x21)
    pps = [pp_to_device(params, pp, engine.device) for _, pp in sess]
    qs = queries(params, sess, nq, [3, 9, 17, 40])
    return [(pps[k % 2], q) for k, q in enumerate(qs)]


def bucket(params, dev, items: list):
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    srv = SpiralKvServerTorch(params, dev)
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    for i in items:
        srv.update_item_raw(i, np.random.default_rng(i).integers(
            0, 256, row_len, dtype=np.uint8).tobytes())
    srv.flush()
    return srv


def paths(dev, nq: int):
    """(path, engine, a zero-arg fn returning the requests to dispatch)."""
    from sdk_tpu_torch.ops.server import SpiralServerTorch
    from sdk_tpu_torch.ops.shard import make_mesh
    from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                      params_from_json)

    params = get_fast_expansion_testing_params()
    eng = SpiralServerTorch(params, dev)
    eng.set_db(random_dense(params, dev))
    reqs = engine_requests(params, eng, nq)
    yield "dense", eng, lambda: reqs

    items = [3, 70, 130]
    srv = bucket(params, dev, items)
    sess = sessions(params, 2, 0x31)
    uids = [srv.setup_raw(pp.serialize(params)) for _, pp in sess]
    blobs = [uids[k % 2].encode() + q.serialize(params)
             for k, q in enumerate(queries(params, sess, nq, items))]
    parsed = [srv._parse_request(b) for b in blobs]
    yield "compact", srv.engine, lambda: parsed

    mesh = make_mesh(8, dp=2, devices=[dev] * 8)
    eng = SpiralServerTorch(params, dev, mesh=mesh)
    eng.set_db(random_dense(params, dev))
    reqs = engine_requests(params, eng, nq)
    yield "sharded", eng, lambda: reqs

    direct = params_from_json(DIRECT_SMALL)
    srv = bucket(direct, dev, [3, 17, 40, 63])
    sess = sessions(direct, 2, 0x51)
    blobs = [sess[k % 2][1].serialize(direct) + q.serialize(direct)
             for k, q in enumerate(queries(direct, sess, nq, [3, 17, 40]))]
    parsed = [srv._parse_request(b) for b in blobs]
    yield "direct", srv.engine, lambda: parsed
    yield "direct_parse", srv.engine, lambda: [srv._parse_request(b)
                                               for b in blobs]


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--nq", default="1,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_sync_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    dev = torch.device("cuda", 0)
    summary: dict = {}
    for nq in [int(x) for x in args.nq.split(",")]:
        for name, eng, requests in paths(dev, nq):
            if name == "direct_parse":
                _, sites = sync_sites(requests)
                warm = checked = None
            else:
                warm = eng.dispatch_queries_batched(requests())()
                torch.cuda.synchronize()
                fetch, sites = sync_sites(
                    lambda: eng.dispatch_queries_batched(requests()))
                checked = fetch()
            where = sorted({s["where"] for s in sites})
            summary.setdefault(name, set()).update(where)
            print(json.dumps({"path": name, "nq": nq,
                              "synchronizing_calls": len(sites),
                              "sites": where,
                              "stacks": sorted({" > ".join(s["stack"])
                                                for s in sites}),
                              "same_bytes_as_warm": checked == warm}),
                  flush=True)
    print(json.dumps({"summary": {k: sorted(v) for k, v in summary.items()},
                      "root": os.path.abspath(args.root),
                      "card": card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
