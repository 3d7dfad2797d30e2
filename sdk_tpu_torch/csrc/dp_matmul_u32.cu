// DoublePIR's wrapping 32-bit products (kernel L): (M, K) uint32 @ (K, N)
// uint32 -> (M, N) uint32 mod 2^32, and the packed form whose left operand
// holds three 10-bit fields per word.
//
// Replaces sdk_tpu/doublepir/jax_kernels.py:35 matmul_u32_traced and its
// packed callers :84 mat_mul_vec_packed_traced and :109
// mat_mul_transposed_packed_traced (with :72 unsquish_traced). The JAX
// program cuts both operands into 7-bit int8 limbs for the MXU, chunks K at
// 2^16 so the int32 limb sums stay exact, and unsquishes the packed operand
// into a copy (in row chunks, to bound that copy). Here the multiply-add is
// the native wrapping one, any K is exact, and the packed form extracts
// field k % 3 of word k / 3 with a shift and a mask while it fills the
// shared-memory tile, so no unsquished copy is written.
//
// One templated kernel: a block computes a BM x BN output tile over one
// split of K, in steps of 32 through shared memory, and adds its sums into
// the zeroed output with atomicAdd (unsigned adds wrap, so the result does
// not depend on the order). Three tile shapes, chosen by the wrapper's
// shapes:
//   M <= 8  (the answer: msg0 = a_1t @ A2 with M = 4, K = 92682, N = 1024;
//            h_2 = a_1t @ q2): 8 x 256 tiles, many K splits, so the work
//            spreads over K and N, not over M. Bound by bytes: b is read
//            once.
//   N <= 8  (packed DB rows @ a query column, general configs): 256 x 8.
//   else    (setup products of general configs): 64 x 64, 4 x 4 per thread.
//           Bound by operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;
constexpr int kSquishBits = 10;   // matrix.py SQUISH_BASIS
constexpr int kSquishFields = 3;  // matrix.py SQUISH_DELTA

template <int BM, int BN, int TM, int TN, bool PACKED>
__global__ void __launch_bounds__(kThreads)
matmul_u32_kernel(const uint32_t* __restrict__ a, long long lda,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  long long M, int K, int N, int k_per_split) {
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kThreads, "one thread per TM x TN sub-tile");
  // a row-major and padded by one word: the fill writes along k and the
  // product reads along rows, both without bank conflicts
  __shared__ uint32_t a_s[BM][BK + 1];
  __shared__ uint32_t b_s[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = kbeg + k_per_split < K ? kbeg + k_per_split : K;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, kk = i % BK;
      const int k = k0 + kk;
      uint32_t v = 0;
      if (m0 + r < M && k < kend) {
        if (PACKED) {
          const uint32_t w = a[(m0 + r) * lda + k / kSquishFields];
          v = (w >> (kSquishBits * (k % kSquishFields))) &
              ((1u << kSquishBits) - 1);
        } else {
          v = a[(m0 + r) * lda + k];
        }
      }
      a_s[r][kk] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN, n = i % BN;
      b_s[kk][n] = (k0 + kk < kend && n0 + n < N)
                       ? b[static_cast<long long>(k0 + kk) * N + n0 + n] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[ty * TM + i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) atomicAdd(&out[m * N + n], acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN, bool PACKED>
cudaError_t launch_shape(const uint32_t* a, long long lda, const uint32_t* b,
                         uint32_t* out, long long M, int K, int N,
                         cudaStream_t stream) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  // enough blocks for four waves over 132 SMs, each split a multiple of BK
  long long splits = (4 * 132 + tiles - 1) / tiles;
  const int ksteps = (K + BK - 1) / BK;
  if (splits > ksteps) splits = ksteps;
  if (splits < 1) splits = 1;
  const int k_per_split =
      static_cast<int>((ksteps + splits - 1) / splits) * BK;
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM),
                  (K + k_per_split - 1) / k_per_split);
  matmul_u32_kernel<BM, BN, TM, TN, PACKED><<<grid, kThreads, 0, stream>>>(
      a, lda, b, out, M, K, N, k_per_split);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch(const uint32_t* a, long long lda, const uint32_t* b,
                   uint32_t* out, long long M, int K, int N,
                   cudaStream_t stream) {
  if (M <= 8)
    return launch_shape<8, 256, 8, 1, PACKED>(a, lda, b, out, M, K, N, stream);
  if (N <= 8)
    return launch_shape<256, 8, 1, 8, PACKED>(a, lda, b, out, M, K, N, stream);
  return launch_shape<64, 64, 4, 4, PACKED>(a, lda, b, out, M, K, N, stream);
}

}  // namespace

// a: (M, K) uint32 with row stride lda words, or with packed != 0 (M,
// ceil(K / 3)) words of three 10-bit fields, field k % 3 of word k / 3 being
// element k; b: (K, N) uint32; out: (M, N) uint32, zeroed by the caller: the
// kernel adds into it.
extern "C" int sdk_dp_matmul_u32(const void* a, long long lda, const void* b,
                                 void* out, long long M, int K, int N,
                                 int packed, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* aa = static_cast<const uint32_t*>(a);
  const auto* bb = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = packed ? launch<true>(aa, lda, bb, o, M, K, N, s)
                                : launch<false>(aa, lda, bb, o, M, K, N, s);
  return static_cast<int>(rc);
}
