#!/usr/bin/env python3
"""The bucket lifecycle's reads on one CUDA card for one checkout of
sdk_tpu_torch: chip_smoke.phase_lifecycle (a fresh 1 GiB bucket through its
S1, S2 and S3 states, its kernel checks included), with several 16-query
batches a state where chip_smoke times one.

    python3 tools/lifecycle_gpu.py [--root DIR] [--batches N]

This checkout's chip_smoke drives the package found under ``--root``
(default: this checkout), so two checkouts are measured by the same code:
run it for each in turn inside one call (parent, change, change, parent).
Each state makes 3 single reads, then N batches (default 3; the first is
the one chip_smoke reports). One JSON line: every read's and batch's wall
ms by state, and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lifecycle_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs           # this checkout's phases

    sys.path.insert(0, os.path.abspath(args.root))   # the package measured
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.params_store import get_params_from_store

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.lib()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)        # the allocator's state, as chip_smoke's
    params = get_params_from_store(15, 32768)
    out = cs.phase_lifecycle(params, cs.Sessions(params), dev,
                             cs.KernelTable(), cs.Launches(),
                             batches=args.batches)
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      **{s: {k: out[s][k] for k in ("single_read_ms_all",
                                                     "batch16_ms_all")}
                         for s in ("S1", "S2", "S3")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
