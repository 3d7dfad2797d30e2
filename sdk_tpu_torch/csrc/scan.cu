// First-dimension scan: the encrypted-query x DB product, the one pass over
// the whole encrypted index.
//
// Replaces: sdk_tpu/ops/spiral_jax.py:430 firstdim_multiply,
// :500 firstdim_multiply_qT and :368 _firstdim_multiply_kconcat, with their
// epilogues _combine_scan_parts (:483) and _combine_weight_groups (:355).
//
//   out[c, z, m, r] = sum_j D[c, z, m, j] * Q[c, z, j, r]  mod q_c
//
// D values (< q < 2^28) are stored as four 7-bit limbs in int8; the query is
// split into four 7-bit limbs in shared memory. Limb products are summed by
// weight with __dp4a into int32 and recombined mod q by the epilogue shared
// with the compact scan (scan_common.cuh). The int32 partials live in
// registers only: they never reach device memory.
//
// DB layout (the port's single dense layout), as int32 words:
//   (crt, Z, L=4, JW=dim0/4, M)   with M = instances * trials * num_per
// where one word holds limb k of the four neighbouring columns j = 4jw..4jw+3
// (byte b = column 4jw+b). M is the minor axis so that the 32 threads of a
// warp, which own 32 consecutive rows m, read 128 contiguous bytes per load,
// and the word is exactly one __dp4a operand. Total bytes equal the JAX
// engine's index_hbm_bytes (server_jax.py:107).
//
// What bounds it on the H100: bytes. The 1 GiB bucket's index is 8.59 GB,
// read once per scan; at R = 2 columns (one query) each DB word feeds 4*R =
// 8 __dp4a, far below the card's integer rate, so HBM bandwidth bounds it.
// At R = 32 (a 16-query batch) each word feeds 128 __dp4a and the integer
// pipes come close to binding. The design streams each DB word from device
// memory exactly once per block column group with coalesced 4-byte loads,
// keeps the query limbs for one (channel, z) in shared memory (read as warp
// broadcasts), and fuses the recombination so the only writes are the
// reduced outputs. Tensor-core (mma.sync / wgmma) and TMA forms are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan_common::kLimbs;
using scan_common::kRowsPerBlock;
using scan_common::kWeights;

template <int RT>
__global__ void scan_kernel(const int32_t* __restrict__ db,
                            const uint32_t* __restrict__ query,
                            uint32_t* __restrict__ out, int Z, int M, int JW,
                            int R, int RB, uint32_t q0, uint32_t q1) {
  extern __shared__ int32_t qs[];  // [kLimbs][JW][RB] packed query limbs
  const int nrb = R / RB;
  const int c = blockIdx.z / nrb;
  const int r0 = (blockIdx.z % nrb) * RB;
  const int z = blockIdx.y;
  const uint32_t q = c ? q1 : q0;
  const int dim0 = 4 * JW;
  const size_t cz = static_cast<size_t>(c) * Z + z;

  // query[c, z, j, r0 + r] -> limb l of columns 4jw..4jw+3 in one word
  const uint32_t* qz = query + cz * dim0 * R;
  for (int idx = threadIdx.x; idx < JW * RB; idx += blockDim.x) {
    const int jw = idx / RB;
    const int r = idx % RB;
    uint32_t v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) v[b] = qz[(4 * jw + b) * R + r0 + r];
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= scan_common::limb(v[b], l) << (8 * b);
      qs[(l * JW + jw) * RB + r] = static_cast<int32_t>(word);
    }
  }
  __syncthreads();

  const int mi = threadIdx.x % kRowsPerBlock;
  const int cg = threadIdx.x / kRowsPerBlock;
  const int m = blockIdx.x * kRowsPerBlock + mi;
  if (m >= M) return;
  const int rb = cg * RT;

  int32_t acc[kWeights][RT];
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[s][rr] = 0;

  const int32_t* dz = db + cz * kLimbs * JW * M + m;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const int32_t* dk = dz + static_cast<size_t>(k) * JW * M;
#pragma unroll 4
    for (int jw = 0; jw < JW; ++jw) {
      const int32_t d = dk[static_cast<size_t>(jw) * M];
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) {
        const int32_t* ql = qs + (l * JW + jw) * RB + rb;
#pragma unroll
        for (int rr = 0; rr < RT; ++rr)
          acc[k + l][rr] = __dp4a(d, ql[rr], acc[k + l][rr]);
      }
    }
  }

  scan_common::recombine_store<RT>(acc, q, out + (cz * M + m) * R + r0 + rb);
}

template <int RT>
int launch(const int32_t* db, const uint32_t* query, uint32_t* out, int crt,
           int Z, int M, int JW, int R, int RB, uint32_t q0, uint32_t q1,
           cudaStream_t st) {
  const size_t smem = sizeof(int32_t) * kLimbs * JW * RB;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, Z, crt * (R / RB));
  const int threads = kRowsPerBlock * (RB / RT);
  scan_kernel<RT><<<grid, threads, smem, st>>>(db, query, out, Z, M, JW, R, RB,
                                               q0, q1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// db: (2, Z, 4, JW, M) int32 words of int8 limbs; query: (2, Z, 4*JW, R)
// uint32 residues; out: (2, Z, M, R) uint32. rt (columns per thread) is one
// of 2, 4, 8 and divides rb (columns per block), which divides R.
extern "C" int sdk_scan(const void* db, const void* query, void* out, int Z,
                        int M, int JW, int R, int rb, int rt, unsigned int q0,
                        unsigned int q1, void* stream) {
  const auto* d = static_cast<const int32_t*>(db);
  const auto* qr = static_cast<const uint32_t*>(query);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 2: return launch<2>(d, qr, o, 2, Z, M, JW, R, rb, q0, q1, st);
    case 4: return launch<4>(d, qr, o, 2, Z, M, JW, R, rb, q0, q1, st);
    case 8: return launch<8>(d, qr, o, 2, Z, M, JW, R, rb, q0, q1, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
