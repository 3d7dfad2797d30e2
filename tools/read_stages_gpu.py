#!/usr/bin/env python3
"""Stage split of a single private read and of a 16-query batch of the 1 GiB
bucket (expand / scan / fold / pack + encode) on one CUDA card, for one
checkout of sdk_tpu_torch.

    python3 tools/read_stages_gpu.py [--root DIR] [--reps N]

Builds the kernels of the package under ``--root`` (default: this
checkout), installs a random dense index of the bucket's full size (8.59
GB; the stages' work does not depend on the rows' contents) in a
SpiralKvServerTorch, sets up the five client sessions of chip_smoke.py and
times ``chip_smoke.stage_breakdown`` (this checkout's, each stage
synchronised) on one read and on a 16-query batch, then the whole read and
batch walls, ``--reps`` rounds of each, medians. It then runs one
torch.profiler session and times the stage split again: CUPTI's tracing
stays attached to the process and slows the launches that follow, so no
measurement of the read path may follow a profiler session in the same
process. One JSON line. Run it for two checkouts in turn inside one call
(parent, change, change, parent): walls of host-bound stages move 25-40%
between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261017
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("read_stages_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params_store import get_params_from_store
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    sys.path.insert(0, HERE)          # this checkout's chip_smoke helpers
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _build.lib()
    params = get_params_from_store(15, 32768)
    srv = SpiralKvServerTorch(params, "cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    srv.engine.db = None
    srv.engine.set_db(torch.randint(0, 128, sj.db_shape(params),
                                    dtype=torch.int8, device=dev,
                                    generator=gen))
    t = time.perf_counter()
    sessions = cs.Sessions(params)
    uids = sessions.setup(srv)
    keys_s = time.perf_counter() - t
    single = [sessions.blob(uids, 0, cs.KEYS[0], 250)]
    batch = [sessions.blob(uids, 1 + i // 4, cs.KEYS[i % 3], 200 + i)
             for i in range(16)]
    srv.private_read_blobs(single)            # warm-up: first launches
    srv.dispatch_read_blobs(batch)()
    torch.cuda.synchronize()

    def walls():
        one, many = [], []
        for _ in range(args.reps):
            t = time.perf_counter()
            srv.private_read_blobs(single)
            torch.cuda.synchronize()
            one.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            srv.dispatch_read_blobs(batch)()
            torch.cuda.synchronize()
            many.append((time.perf_counter() - t) * 1e3)
        return float(np.median(one)), float(np.median(many))

    out = {"card": card, "root": os.path.abspath(args.root),
           "client_keys_s": keys_s}
    out["stages_ms_single"] = cs.stage_breakdown(srv, single)
    out["stages_ms_batch16"] = cs.stage_breakdown(srv, batch)
    out["single_read_ms"], out["batch16_ms"] = walls()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        srv.private_read_blobs(single)
        torch.cuda.synchronize()
    out["after_profiler"] = {
        "stages_ms_single": cs.stage_breakdown(srv, single),
        "stages_ms_batch16": cs.stage_breakdown(srv, batch)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
