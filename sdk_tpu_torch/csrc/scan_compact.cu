// Compact first-dimension scan: the encrypted-query x DB product over the
// O(populated) compact index, which stores per num_per bin only the first-dim
// columns that hold an item.
//
// Replaces: sdk_tpu/ops/spiral_jax.py:291 _firstdim_multiply_compact (reached
// from firstdim_multiply :430 and firstdim_multiply_qT :500 on a CompactDb).
//
//   out[c, z, m, r] = sum_{s < cap} D[c, z, m, s] * Q[c, z, idx_j[b(m), s], r]
//                     mod q_c,   b(m) = m mod num_per
//
// Unoccupied slots hold zero limbs (and idx_j 0), so they add exactly zero:
// the result equals the dense scan of the equivalent dense index word for
// word. The sums and the epilogue are the dense scan's (scan_common.cuh); the
// int32 bound holds because cap <= dim0 <= 2^15.
//
// Layout: the dense scan's with the slot axis in place of dim0, as int32
// words (crt, Z, L=4, CW=cap/4, M), M = instances * trials * num_per minor,
// one word = limb k of the four slots 4cw .. 4cw+3 of row m. A warp's 32
// threads own 32 consecutive rows and read 128 contiguous bytes per load, as
// in the dense scan; idx_j is (num_per, cap) int32.
//
// The gather: the block keeps, for its (channel, z) and column block, every
// query column's four limbs packed in one word, W[j][r] = limb0 | limb1<<8 |
// limb2<<16 | limb3<<24, in shared memory (4 * dim0 * (RB + 1) bytes: rows
// padded by one word, so that a warp's 32 rows, each gathering a different
// query row j, hit bank (j + r) mod 32 and not all the same bank, as a stride
// of RB = 32 would make them). For one DB
// word a thread loads the words of its bin's four slot columns, W[idx_j[b,
// 4cw+t]][r] for t = 0..3, and a 4x4 byte transpose (8 __byte_perm) turns
// them into the four __dp4a operands (limb l of the four columns). The
// gathered (crt, z, num_per, cap, R) query never exists in device memory (at
// R = 32 and cap 128 it would take 4.3 GB).
//
// What bounds it on the H100: bytes, at the shapes the bucket runs. The
// compact index is 2 * 4 * 2048 * 16 * 64 * cap bytes at the 1 GiB bucket:
// 134 MB at cap 8 (0.04 ms at 3.35 TB/s) and 2.15 GB at cap 128 (0.64 ms).
// Each DB word feeds 4 * R __dp4a; each slot word adds 4 shared loads and 8
// byte permutes per column, shared by its four limbs. So at R = 32 the
// integer pipes come close to binding, as in the dense scan.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan_common::kLimbs;
using scan_common::kRowsPerBlock;
using scan_common::kWeights;

template <int RT>
__global__ void scan_compact_kernel(const int32_t* __restrict__ db,
                                    const int32_t* __restrict__ idx_j,
                                    const uint32_t* __restrict__ query,
                                    uint32_t* __restrict__ out, int Z, int M,
                                    int NPR, int CW, int DIM0, int R, int RB,
                                    uint32_t q0, uint32_t q1) {
  extern __shared__ uint32_t qw[];  // [DIM0][RB + 1] packed query limbs
  const int nrb = R / RB;
  const int c = blockIdx.z / nrb;
  const int r0 = (blockIdx.z % nrb) * RB;
  const int z = blockIdx.y;
  const uint32_t q = c ? q1 : q0;
  const size_t cz = static_cast<size_t>(c) * Z + z;

  const uint32_t* qz = query + cz * DIM0 * R;
  const int ld = RB + 1;  // padded row stride of qw
  for (int idx = threadIdx.x; idx < DIM0 * RB; idx += blockDim.x) {
    const uint32_t v = qz[(idx / RB) * R + r0 + idx % RB];
    uint32_t word = 0;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      word |= scan_common::limb(v, l) << (8 * l);
    qw[(idx / RB) * ld + idx % RB] = word;
  }
  __syncthreads();

  const int mi = threadIdx.x % kRowsPerBlock;
  const int cg = threadIdx.x / kRowsPerBlock;
  const int m = blockIdx.x * kRowsPerBlock + mi;
  if (m >= M) return;
  const int rb = cg * RT;
  // idx_j rows are 4*CW int32 long and 16-byte aligned (CW >= 1)
  const int4* slots = reinterpret_cast<const int4*>(idx_j) +
                      static_cast<size_t>(m % NPR) * CW;

  int32_t acc[kWeights][RT];
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[s][rr] = 0;

  const int32_t* dz = db + cz * kLimbs * CW * M + m;
#pragma unroll 2
  for (int cw = 0; cw < CW; ++cw) {
    const int4 j4 = slots[cw];
    int32_t d[kLimbs];
#pragma unroll
    for (int k = 0; k < kLimbs; ++k)
      d[k] = dz[(static_cast<size_t>(k) * CW + cw) * M];
    const uint32_t* w0 = qw + j4.x * ld + rb;
    const uint32_t* w1 = qw + j4.y * ld + rb;
    const uint32_t* w2 = qw + j4.z * ld + rb;
    const uint32_t* w3 = qw + j4.w * ld + rb;
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      // rows: slot t's word (its limbs 0..3); columns -> limb l's word
      // (its slots 0..3)
      const uint32_t a = __byte_perm(w0[rr], w1[rr], 0x5140);
      const uint32_t b = __byte_perm(w0[rr], w1[rr], 0x7362);
      const uint32_t e = __byte_perm(w2[rr], w3[rr], 0x5140);
      const uint32_t f = __byte_perm(w2[rr], w3[rr], 0x7362);
      const int32_t ql[kLimbs] = {
          static_cast<int32_t>(__byte_perm(a, e, 0x5410)),
          static_cast<int32_t>(__byte_perm(a, e, 0x7632)),
          static_cast<int32_t>(__byte_perm(b, f, 0x5410)),
          static_cast<int32_t>(__byte_perm(b, f, 0x7632))};
#pragma unroll
      for (int k = 0; k < kLimbs; ++k)
#pragma unroll
        for (int l = 0; l < kLimbs; ++l)
          acc[k + l][rr] = __dp4a(d[k], ql[l], acc[k + l][rr]);
    }
  }

  scan_common::recombine_store<RT>(acc, q, out + (cz * M + m) * R + r0 + rb);
}

template <int RT>
int launch(const int32_t* db, const int32_t* idx_j, const uint32_t* query,
           uint32_t* out, int crt, int Z, int M, int NPR, int CW, int DIM0,
           int R, int RB, uint32_t q0, uint32_t q1, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * DIM0 * (RB + 1);
  cudaError_t err = cudaFuncSetAttribute(
      scan_compact_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, Z, crt * (R / RB));
  const int threads = kRowsPerBlock * (RB / RT);
  scan_compact_kernel<RT><<<grid, threads, smem, st>>>(
      db, idx_j, query, out, Z, M, NPR, CW, DIM0, R, RB, q0, q1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// db: (2, Z, 4, CW, M) int32 words of int8 limbs; idx_j: (NPR, 4*CW) int32
// with M a multiple of NPR; query: (2, Z, DIM0, R) uint32 residues; out:
// (2, Z, M, R) uint32. rt (columns per thread) is one of 2, 4, 8 and divides
// rb (columns per block), which divides R.
extern "C" int sdk_scan_compact(const void* db, const void* idx_j,
                                const void* query, void* out, int Z, int M,
                                int NPR, int CW, int DIM0, int R, int rb,
                                int rt, unsigned int q0, unsigned int q1,
                                void* stream) {
  const auto* d = static_cast<const int32_t*>(db);
  const auto* ij = static_cast<const int32_t*>(idx_j);
  const auto* qr = static_cast<const uint32_t*>(query);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 2:
      return launch<2>(d, ij, qr, o, 2, Z, M, NPR, CW, DIM0, R, rb, q0, q1, st);
    case 4:
      return launch<4>(d, ij, qr, o, 2, Z, M, NPR, CW, DIM0, R, rb, q0, q1, st);
    case 8:
      return launch<8>(d, ij, qr, o, 2, Z, M, NPR, CW, DIM0, R, rb, q0, q1, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
