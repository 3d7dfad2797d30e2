#!/usr/bin/env python3
"""How fast one CUDA card streams the checklist answer's a_2 operand
(two int8 planes of 4,096 rows x 92,682 bytes, rows 92,688 bytes apart)
by the length of the runs a warp reads along a row.

    python3 tools/row_runs_gpu.py

Builds a probe kernel with nvcc into build/row_runs/ and reads both
planes whole with a grid of K splits x row groups, 8 warps a block, each
load 16 bytes a lane and its data folded into a sink so nothing is
skipped:

- ``runs64`` / ``runs128`` / ``runs256``: lane (g, t) reads rows g and
  g + 8 of each of the warp's MT m16 tiles in each plane at 16t + 64c,
  c = 0 .. C - 1: a warp's load covers 64 contiguous bytes of 8 rows, and
  C of them a run of 64 C bytes a row (kernel K's narrow form's fragment
  order); MT = 2 (256-row groups) and MT = 1 (128, the narrow form's);
- ``rows512``: a warp reads 512 contiguous bytes of one of its 32 rows a
  load, 16 loads in flight a thread (256-row groups);
- ``*_l2pf256``: runs64 / runs256 (MT = 2) with each load carrying the L2
  prefetch hint of a 256-byte run (``.L2::256B``), as the narrow form's
  copies do.

Each with one wave of blocks at one block an SM and at two. One JSON line:
the card, then per pattern the mean ms of 20 launches (CUDA events) and
the bytes a second.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from chip_smoke import cuda_ms  # noqa: E402

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

template <bool PF = false>
__device__ __forceinline__ uint4 ld16(const int8_t* p) {
  uint4 v;
  if (PF)   // with the L2 prefetch hint of a 256-byte run
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  else
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

template <int C, int MT, bool PF = false>
__global__ void __launch_bounds__(256) runs(const int8_t* a0, const int8_t* a1,
                                            long long lda, int K, int split_k,
                                            uint32_t* sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.y * 128 * MT + warp * 16 * MT;
  const int kbeg = blockIdx.x * split_k, kend = min(K, kbeg + split_k);
  uint32_t acc = 0;
  for (int k = kbeg; k < kend; k += 64 * C) {
    uint4 r[2][MT][2][C];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int kk = k + 64 * c + 16 * t;
            r[p][i][h][c] = kk < kend ? ld16<PF>((p ? a1 : a0) +
                (m0 + 16 * i + g + 8 * h) * lda + kk) : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc ^= r[p][i][h][c].x ^ r[p][i][h][c].y ^ r[p][i][h][c].z ^
                   r[p][i][h][c].w;
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

__global__ void __launch_bounds__(256) rows512(const int8_t* a0,
                                               const int8_t* a1, long long lda,
                                               int K, int split_k,
                                               uint32_t* sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m0 = (long long)blockIdx.y * 256 + warp * 32;
  const int kbeg = blockIdx.x * split_k, kend = min(K, kbeg + split_k);
  uint32_t acc = 0;
  for (int k = kbeg; k < kend; k += 512) {
    for (int q0 = 0; q0 < 64; q0 += 16) {       // (row, plane) pairs
      uint4 r[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int q = q0 + u, kk = k + 16 * lane;
        r[u] = kk < kend ? ld16(((q & 1) ? a1 : a0) + (m0 + (q >> 1)) * lda +
                                kk) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) acc ^= r[u].x ^ r[u].y ^ r[u].z ^ r[u].w;
    }
  }
  if (acc == 0x9E3779B9u) sink[0] = acc;
}

extern "C" int probe(int pattern, const void* a0, const void* a1,
                     long long lda, int K, int split_k, int splits,
                     int groups, void* sink) {
  const dim3 grid(splits, groups);
  const auto* x = static_cast<const int8_t*>(a0);
  const auto* y = static_cast<const int8_t*>(a1);
  auto* s = static_cast<uint32_t*>(sink);
  switch (pattern) {
    case 12: runs<1, 2><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 22: runs<2, 2><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 42: runs<4, 2><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 11: runs<1, 1><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 41: runs<4, 1><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 13: runs<1, 2, true><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    case 43: runs<4, 2, true><<<grid, 256>>>(x, y, lda, K, split_k, s); break;
    default: rows512<<<grid, 256>>>(x, y, lda, K, split_k, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# name -> (pattern, rows a block)
PATTERNS = {"runs64_mt2": (12, 256), "runs128_mt2": (22, 256),
            "runs256_mt2": (42, 256), "runs64_mt1": (11, 128),
            "runs256_mt1": (41, 128), "rows512": (0, 256),
            "runs64_mt2_l2pf256": (13, 256), "runs256_mt2_l2pf256": (43, 256)}


def build() -> ctypes.CDLL:
    out = os.path.join(HERE, "build", "row_runs")
    os.makedirs(out, exist_ok=True)
    src, lib = os.path.join(out, "row_runs.cu"), os.path.join(out,
                                                              "librow_runs.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(lib)
    so.probe.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("row_runs_gpu: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    so = build()
    dev = torch.device("cuda", 0)
    rows, K, lda = 4096, 92682, 92688
    gen = torch.Generator(device=dev).manual_seed(7)
    planes = [torch.randint(-128, 128, (rows, lda), dtype=torch.int8,
                            device=dev, generator=gen) for _ in range(2)]
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"card": card, "bytes": 2 * rows * K}
    units = -(-K // 256)
    for per_sm in (1, 2):
        for name, (pattern, block_rows) in PATTERNS.items():
            groups = rows // block_rows
            splits = min(units, sms * per_sm // groups)
            split_k = -(-units // splits) * 256

            def run():
                rc = so.probe(pattern, planes[0].data_ptr(),
                              planes[1].data_ptr(), lda, K, split_k, splits,
                              groups, sink.data_ptr())
                if rc:
                    raise RuntimeError(f"probe {name}: CUDA error {rc}")
            ms = cuda_ms(run, 20)
            out[f"{name}_{per_sm}_per_sm"] = {
                "ms": ms, "GBps": out["bytes"] / ms / 1e6,
                "blocks": splits * groups}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
