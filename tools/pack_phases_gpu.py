#!/usr/bin/env python3
"""Where one block of kernel G (sdk_tpu_torch/csrc/pack.cu) spends its time,
phase by phase, on one CUDA card.

    python3 tools/pack_phases_gpu.py [--reps N]

Copies this checkout's sdk_tpu_torch package to build/pack_phases/, adds to
the copy's pack.cu a clock64() probe after every block barrier of the kernel
(block 0, thread 0, into a __device__ array) and an entry point that reads
the probes back, builds the copy, runs G in its one-block form (one block a
column: the whole chain in block 0) on random inputs at the 1 GiB bucket's
shapes (NQ = 1 and 16, per-query keys, the NTT and the words modes; warm
calls first) and prints one JSON line: for each case the SM
cycles between consecutive probes, named by the phase they close (rounds of
forward transforms, combines, the shift step's inverse and compose, the
final inverse, compose and bit-pack), their sum, and the card's name, power
limit and maximum SM clock. The probes cost a few instructions a barrier;
the uninstrumented kernel's device time is chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(HERE, "build", "pack_phases")
SEED = 20261017

PROBES = '''
__device__ unsigned long long g_clk[128];
__device__ int g_nclk;
#define PROBE() do { if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  g_clk[g_nclk++ & 127] = clock64(); } } while (0)
'''
READER = '''
extern "C" int sdk_pack_clocks(void* out, void* n) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(n, g_nclk, sizeof(int));
  return static_cast<int>(err);
}
'''


def instrument(src: str) -> str:
    """pack.cu with a probe at the kernel's start, after each of its block
    barriers and at its end, and the reader entry point."""
    anchor = "using namespace sdk::core;\n"
    src = src.replace(anchor, anchor + PROBES, 1)
    head = src.index("pack_kernel(PackArgs a) {")
    tail = src.index("\n}\n", head)
    body = src[head:tail]
    body = body.replace("{\n", "{\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
                        "g_nclk = 0;\n  PROBE();\n", 1)
    body = body.replace("__syncthreads();", "__syncthreads(); PROBE();")
    return src[:head] + body + "\n  PROBE();" + src[tail:] + READER


def phase_names(params, pairs: int, mode: str) -> list[str]:
    """The phase each probe closes, in the kernel's order (csrc/pack.cu)."""
    n, tc = params.n, params.t_conv
    names = []
    for r in range(n):
        for i, _ in enumerate(range(0, 1 + tc, pairs)):
            names += [f"r{r} round {i}", f"r{r} combine {i}"]
        for s in range(r if params.version else 0):
            names += [f"r{r} shift {s} inverse", f"r{r} shift {s} compose"]
            for i, _ in enumerate(range(0, tc, pairs)):
                names += [f"r{r} shift {s} round {i}",
                          f"r{r} shift {s} combine {i}"]
    names[0] = "start + " + names[0]
    if mode == "ntt":
        return names + ["ntt copy"]
    for i, _ in enumerate(range(0, n + 1, pairs)):
        names += [f"final {i} inverse", f"final {i} compose"
                  + (" + rescale" if mode == "words" else "")]
        if mode == "words":
            names.append(f"final {i} bit-pack")
    return names + ["exit"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pack_phases_gpu: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "sdk_tpu_torch"),
                    os.path.join(COPY, "sdk_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(COPY, "sdk_tpu_torch", "csrc", "pack.cu")
    with open(cu) as f:
        src = f.read()
    with open(cu, "w") as f:
        f.write(instrument(src))
    sys.path.insert(0, COPY)
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan
    from sdk_tpu_torch.params_store import get_params_from_store

    if not sj.__file__.startswith(COPY):
        raise RuntimeError(f"imported {sj.__file__}, not the copy")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    reader = ctypes.CDLL(str(_build.build()["pack"])).sdk_pack_clocks
    reader.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    params = get_params_from_store(15, 32768)
    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(SEED)
    plan = ResponseEncodePlan(params, dev)
    pairs = sj.pack_tiling(params, 1, sj._sm_count(dev), 1).pairs
    n, z = params.n, params.poly_len
    out = {"card": card, "pairs": pairs}
    for nq in (1, 16):
        keys = [[torch.from_numpy(np.stack(
            [gen.integers(0, q, (n + 1, params.t_conv, z))
             for q in params.moduli], axis=-2).astype(np.int32)).to(dev)
            for _ in range(2 if params.version else n)] for _ in range(nq)]
        v_ct = torch.from_numpy(gen.integers(
            0, params.modulus, (nq, params.instances, n * n, 2, 1, z),
            dtype=np.int64)).to(dev)
        for mode in ("ntt", "words"):
            runs = []
            for _ in range(args.reps):
                sj._pack_launch(params, v_ct, keys, mode, plan, 1)
                clk = (ctypes.c_ulonglong * 128)()
                cnt = ctypes.c_int()
                rc = reader(clk, ctypes.byref(cnt))
                if rc != 0:
                    raise RuntimeError(f"reading the probes: CUDA error {rc}")
                c = list(clk)[:cnt.value]
                runs.append([c[i + 1] - c[i] for i in range(len(c) - 1)])
            names = phase_names(params, pairs, mode)
            if any(len(r) != len(names) for r in runs):
                raise RuntimeError(f"{len(runs[0])} probes, {len(names)} "
                                   f"phases expected")
            med = [int(np.median([r[i] for r in runs[1:] or runs]))
                   for i in range(len(names))]
            out[f"nq{nq}_{mode}"] = {"cycles": dict(zip(names, med)),
                                     "total_cycles": sum(med)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
