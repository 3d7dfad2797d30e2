#!/usr/bin/env python3
"""Time kernel C (the dense first-dimension scan) or kernel I (the compact
scan) of sdk_tpu_torch on one CUDA card, on a random index of the 1 GiB
bucket's full size.

    python3 tools/scan_bench_gpu.py [--kernel dense|compact] [--root DIR]
                                    [--sweep] [--iters N] [--columns 2,32]

Builds the kernels of the sdk_tpu_torch package found under ``--root``
(default: this checkout). ``--kernel dense`` (the default) fills an 8.59 GB
dense index (2 channels x 2048 z x 4 limbs x 128 words x 1024 rows) with
random 7-bit limbs from a seed; ``--kernel compact`` fills the compact
indexes of the lifecycle's S1 (cap 8, 134 MB) and S2 (cap 128, 2.15 GB)
states, every slot occupied, each bin's slots on distinct random dim0
columns. Each index is checked against the kernel's plain version on a
z-slice; one JSON line then gives the whole-index time at R = 2 and R = 32
columns (a single read and a 16-query batch; ``--columns`` names others),
its bound (bytes moved, or int8 operations at the tensor-core peak) and
share of it, and the time of ``torch._int_mm`` over the same int8 bytes at
8 and 32 columns (a yardstick the port never calls; its output bytes stand
beside the scan's: over the S1 index at 32 columns it writes 8x fewer). ``--root`` lets
one call time two checkouts in turn, each in its own process (parent,
change, change, parent). ``--sweep`` also times every tiling that
``scan_tiling`` or ``compact_scan_tiling`` offers (a checkout that has
one).
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


def int_mm_ms(torch, planes, cols: int, iters: int) -> float:
    a = planes.view(-1, 256)
    b = torch.ones((256, cols), dtype=torch.int8, device=planes.device)
    return cuda_ms(torch, lambda: torch._int_mm(a, b), iters)


def bench_compact(torch, sj, params, dev, gen, cap: int, args) -> dict:
    """Kernel I on a full-size compact index of cap slots a bin."""
    planes = torch.randint(0, 128, sj.compact_shape(params, cap),
                           dtype=torch.int8, device=dev, generator=gen)
    crt, z, L, cw, inst, trials, npr, _ = planes.shape
    dim0 = 1 << params.db_dim_1
    idx_j = torch.stack([torch.randperm(dim0, device=dev, generator=gen)[:cap]
                         for _ in range(npr)]).to(torch.int32)
    db = sj.CompactDb(planes, idx_j)
    M = inst * trials * npr
    index_bytes = planes.numel()
    row = {"cap": cap, "index_bytes": index_bytes}
    for R in map(int, args.columns.split(",")):
        q_arr = torch.stack([torch.randint(0, q, (z, dim0, R),
                                           dtype=torch.int32, device=dev,
                                           generator=gen)
                             for q in params.moduli])
        zs = 16
        sl = sj.CompactDb(planes[:, :zs].contiguous(), idx_j)
        q_sl = q_arr[:, :zs].contiguous()
        err = int((sj.firstdim_multiply(params, sl, q_sl).long()
                   - sj.firstdim_multiply_compact_plain(params, sl, q_sl)
                   .long()).abs().max())
        if err:
            raise AssertionError(f"cap {cap} R={R}: kernel != plain (max abs "
                                 f"err {err})")
        ms = cuda_ms(torch, lambda: sj.firstdim_multiply(params, db, q_arr),
                     args.iters)
        out_bytes = crt * z * M * R * 4
        moved = index_bytes + idx_j.numel() * 4 + q_arr.numel() * 4 + out_bytes
        bnd = max(moved / HBM_BYTES_PER_S,
                  2 * index_bytes * 4 * R / INT8_OPS_PER_S) * 1e3
        r = {"ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
             "GBps": index_bytes / ms / 1e6, "out_bytes": out_bytes}
        for cols in (8, 32):
            r[f"int_mm_ms_{cols}"] = int_mm_ms(torch, planes, cols, args.iters)
            r[f"int_mm_out_bytes_{cols}"] = index_bytes // 256 * cols * 4
        if args.sweep and hasattr(sj, "compact_scan_tiling"):
            sweep = {}
            default = sj.compact_scan_tiling(R, npr, dim0, cap)
            forms = {default}
            for ntw in (1, 2, 4):
                for gpb in (1, 2, 4, 8):
                    forms.add(sj.compact_scan_tiling(R, npr, dim0, cap,
                                                     ntw=ntw, gpb=gpb))
            for ns in (2, 3):
                forms.add(default._replace(ns=ns))
            forms.add(default._replace(vec=0))
            forms.add(sj.compact_scan_tiling(R, npr, dim0, cap, sw=8))
            for tl in sorted(forms):
                key = (f"ntw{tl.ntw}_rb{tl.rb}_gpb{tl.gpb}_ns{tl.ns}"
                       f"_vec{tl.vec}_sw{tl.sw}")
                sweep[key] = cuda_ms(torch, lambda: sj._scan_compact_launch(
                    params, db, q_arr, tl), args.iters)
            r["sweep_ms"] = sweep
            r["tiling"] = default._asdict()
        row[f"R{R}"] = r
        del q_arr, q_sl
    del planes, db
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--columns", default="2,32")
    ap.add_argument("--kernel", choices=("dense", "compact"), default="dense")
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
    if args.kernel == "compact":
        out = {"card": card, "root": os.path.abspath(args.root)}
        for state, cap in (("S1", 8), ("S2", 128)):
            out[state] = bench_compact(torch, sj, params, dev, gen, cap, args)
        if hasattr(_build, "ptxas_usage"):
            out["ptxas"] = _build.ptxas_usage("scan_compact")
        print(json.dumps(out))
        return 0
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
            row[f"int_mm_ms_{cols}"] = int_mm_ms(torch, db, cols, args.iters)
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
