#!/usr/bin/env python3
"""Time kernel C (the dense first-dimension scan) of sdk_tpu_torch on one
CUDA card, on a random index of the 1 GiB bucket's full size.

    python3 tools/scan_bench_gpu.py [--root DIR] [--sweep] [--iters N]
                                    [--columns 2,32]

Builds the kernels of the sdk_tpu_torch package found under ``--root``
(default: this checkout), fills an 8.59 GB dense index (2 channels x 2048 z
x 4 limbs x 128 words x 1024 rows) with random 7-bit limbs from a seed,
checks the kernel against its plain version on a z-slice, and prints one
JSON line: the whole-index time at R = 2 and R = 32 columns (a single read
and a 16-query batch; ``--columns`` names others), its byte bound and share of it, and the time of
``torch._int_mm`` over the same int8 bytes at 8 and 32 columns (a yardstick
the port never calls). ``--root`` lets one call time two checkouts in turn,
each in its own process (parent, change, change, parent). ``--sweep`` also
times every tiling that ``scan_tiling`` offers (a checkout that has one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 tensor-core peak (dense)


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--columns", default="2,32")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("scan_bench_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params_store import get_params_from_store

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.lib()
    params = get_params_from_store(15, 32768)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    db = torch.randint(0, 128, sj.db_shape(params), dtype=torch.int8,
                       device=dev, generator=gen)
    crt, z, L, jw, inst, trials, npr, _ = db.shape
    M = inst * trials * npr
    index_bytes = db.numel()
    out = {"card": card, "root": os.path.abspath(args.root),
           "index_bytes": index_bytes}
    for R in map(int, args.columns.split(",")):
        q_arr = torch.stack([torch.randint(0, q, (z, 4 * jw, R),
                                           dtype=torch.int32, device=dev,
                                           generator=gen)
                             for q in params.moduli])
        zs = 16
        got = sj.firstdim_multiply(params, db[:, :zs].contiguous(),
                                   q_arr[:, :zs].contiguous())
        want = sj.firstdim_multiply_plain(params, db[:, :zs].contiguous(),
                                          q_arr[:, :zs].contiguous())
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"R={R}: kernel != plain (max abs err {err})")
        ms = cuda_ms(torch, lambda: sj.firstdim_multiply(params, db, q_arr),
                     args.iters)
        moved = index_bytes + q_arr.numel() * 4 + crt * z * M * R * 4
        bnd = max(moved / HBM_BYTES_PER_S,
                  2 * index_bytes * 4 * R / INT8_OPS_PER_S) * 1e3
        row = {"ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
               "GBps": index_bytes / ms / 1e6}
        for cols in (8, 32):
            a = db.view(-1, 256)
            b = torch.ones((256, cols), dtype=torch.int8, device=dev)
            row[f"int_mm_ms_{cols}"] = cuda_ms(
                torch, lambda: torch._int_mm(a, b), args.iters)
        if args.sweep and hasattr(sj, "scan_tiling"):
            sweep = {}
            default = sj.scan_tiling(R, M, z, jw)
            for ntw in sorted({default.ntw, 2 if R >= 16 else 1}):
                for warps in (4, 8):
                    for mtw in (1, 2, 4, 16):
                        tl = sj.scan_tiling(R, M, z, jw, ntw=ntw, warps=warps,
                                            mtw=mtw)
                        key = f"ntw{ntw}_w{warps}_mtw{tl.mtw}"
                        sweep[key] = cuda_ms(
                            torch, lambda: sj._scan_launch(
                                params, db, q_arr, tl), args.iters)
            row["sweep_ms"] = sweep
            row["tiling"] = sj.scan_tiling(R, M, z, jw)._asdict()
        out[f"R{R}"] = row
        del q_arr, got, want
    if hasattr(_build, "ptxas_usage"):
        out["ptxas"] = _build.ptxas_usage("scan")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
