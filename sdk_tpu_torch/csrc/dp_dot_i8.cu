// DoublePIR's int8 DB products (kernel K): (M, K) int8 @ (K, N) uint32 ->
// (M, N) uint32, exact mod 2^32, plus a constant row added to every output
// row.
//
// Replaces sdk_tpu/doublepir/server_jax.py:52 _dot_i8_u32 and :90
// _dot_i8pair_u32, with the `c * colsum(b)` rows of :248 and :457 and the
// diagonal row-batch select of :458. The JAX program splits b into five
// 7-bit limb planes because the MXU multiplies int8 only, and needs
// 128 * 127 * K < 2^31 for its int32 partial sums. A CUDA core multiplies 32
// bits natively: acc += (uint32_t)(int32_t)a * b wraps mod 2^32 and is exact
// for any K, with one IMAD per product (dp4a over 7-bit limbs would take
// 5/4 dp4a per product), so there is no limb, no bound on K and no int32
// partial product tensor.
//
// The pair form takes a 10-bit digit operand stored as two int8 planes,
// a = a_lo + (a_hi << 7), recombined in registers.
//
// Two kernels, chosen by N:
//
// * rows (N <= 8: the online answer). A block takes 8 rows of `a` and all
//   N columns; its 256 threads stride over K four bytes at a time, so a warp
//   reads 128 contiguous bytes of each row, keep 8 x N sums in registers and
//   reduce them with shuffles at the end; with several columns the 4 x N
//   words of b that go with them are read with 16-byte loads. With batches
//   > 1 the rows are cut into `nbatch` row batches (the last takes the remainder)
//   and batch q multiplies only its own column, given as row q of a
//   transposed (nbatch, K) operand: the level-1 pass of the answer computes,
//   per row, only the column its batch selects, in one pass over the DB.
//   Bound by bytes: the 8.59 GB DB is read once; one PRMT and one IMAD per
//   byte stay under it.
//
// * tiled (N > 8: the hint setup, DB @ A1 and digits @ A2). A 128 x 128
//   output tile per block, K in steps of 32 through shared memory (`a`
//   sign-extended to 32 bits on the way in), 8 x 8 sums per thread. Bound by
//   operations: M * K * N 32-bit multiply-adds on the CUDA cores.
//
// Rows of `a` start on 4-byte boundaries (lda % 4 == 0, lda >= K rounded up
// to 4); bytes past K in a row are read and multiplied by zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;      // rows per block of the rows kernel
constexpr int kWarps = kThreads / 32;

// Byte j of w, sign-extended to 32 bits, in one PRMT: selector nibble j
// picks the byte, nibble 8|j replicates its sign bit.
template <int J>
__device__ __forceinline__ int32_t sext_byte(uint32_t w) {
  constexpr uint32_t s = J | ((8u | J) << 4) | ((8u | J) << 8) |
                         ((8u | J) << 12);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(w), "r"(0u), "r"(s));
  return static_cast<int32_t>(d);
}

__device__ __forceinline__ void unpack4(uint32_t w, int32_t v[4]) {
  v[0] = sext_byte<0>(w);
  v[1] = sext_byte<1>(w);
  v[2] = sext_byte<2>(w);
  v[3] = sext_byte<3>(w);
}

// Four elements of a row, sign-extended; the pair form recombines
// a = a_lo + (a_hi << 7) in registers.
template <bool PAIR>
__device__ __forceinline__ void load4(const int8_t* __restrict__ lo,
                                      const int8_t* __restrict__ hi,
                                      long long off, int32_t v[4]) {
  unpack4(*reinterpret_cast<const uint32_t*>(lo + off), v);
  if constexpr (PAIR) {
    int32_t h[4];
    unpack4(*reinterpret_cast<const uint32_t*>(hi + off), h);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += h[j] << 7;
  }
}

// out[r, c] = sum_k a[r, k] * b_q[k, c] + add[q * N + c] for the rows r of
// batch q = blockIdx.y, where b_q = b + q * b_batch_stride is (K, N).
template <bool PAIR, int NC>
__global__ void __launch_bounds__(kThreads)
dot_i8_rows_kernel(const int8_t* __restrict__ a_lo,
                   const int8_t* __restrict__ a_hi, long long lda,
                   const uint32_t* __restrict__ b, int N,
                   long long b_batch_stride, const uint32_t* __restrict__ add,
                   uint32_t* __restrict__ out, long long M, int K,
                   long long rows_per_batch, int nbatch) {
  const int q = blockIdx.y;
  const long long r0 = q * rows_per_batch;
  const long long r1 = q == nbatch - 1 ? M : r0 + rows_per_batch;
  const long long row0 = r0 + static_cast<long long>(blockIdx.x) * kRows;
  if (row0 >= r1) return;
  const int nrows = static_cast<int>(r1 - row0 < kRows ? r1 - row0 : kRows);
  const uint32_t* bq = b + q * b_batch_stride;

  uint32_t acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0;

  // with several columns (N == NC > 1) the 4 * NC words of b for k .. k+3
  // are contiguous: 16-byte loads when the operand starts on a 16-byte
  // boundary. One column keeps its four 4-byte loads, which measured faster.
  const bool vec = NC > 1 && N == NC &&
                   (reinterpret_cast<uintptr_t>(bq) & 15) == 0;
  const int kwords = (K + 3) / 4;
  for (int kw = threadIdx.x; kw < kwords; kw += kThreads) {
    const int k = kw * 4;
    uint32_t bv[4][NC];
    if (vec && k + 3 < K) {
      const uint4* p =
          reinterpret_cast<const uint4*>(bq + static_cast<long long>(k) * NC);
#pragma unroll
      for (int i = 0; i < NC; ++i) {   // word w of the run: bv[w/NC][w%NC]
        const uint4 t = p[i];
        bv[(4 * i) / NC][(4 * i) % NC] = t.x;
        bv[(4 * i + 1) / NC][(4 * i + 1) % NC] = t.y;
        bv[(4 * i + 2) / NC][(4 * i + 2) % NC] = t.z;
        bv[(4 * i + 3) / NC][(4 * i + 3) % NC] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          bv[j][c] = (c < N && k + j < K)
                         ? bq[static_cast<long long>(k + j) * N + c] : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        int32_t v[4];
        load4<PAIR>(a_lo, a_hi, (row0 + r) * lda + k, v);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[r][c] += static_cast<uint32_t>(v[j]) * bv[j][c];
      }
    }
  }

  __shared__ uint32_t part[kWarps][kRows * NC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t s = acc[r][c];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
      if (lane == 0) part[warp][r * NC + c] = s;
    }
  __syncthreads();
  if (threadIdx.x < kRows * NC) {
    const int r = threadIdx.x / NC, c = threadIdx.x % NC;
    if (r < nrows && c < N) {
      uint32_t s = add ? add[q * N + c] : 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
      out[(row0 + r) * N + c] = s;
    }
  }
}

constexpr int BM = 128, BN = 128, BK = 32;

// out[m, n] = sum_k a[m, k] * b[k, n] + add[n]; one 128 x 128 tile a block.
// Thread (ty, tx) of 16 x 16 holds rows {ty*4 .. +3, 64 + ty*4 .. +3} and
// columns {tx*4 .. +3, 64 + tx*4 .. +3}: each shared-memory read is one
// 16-byte load, and a quarter warp reads 128 contiguous bytes of b.
template <bool PAIR>
__global__ void __launch_bounds__(kThreads)
dot_i8_tiled_kernel(const int8_t* __restrict__ a_lo,
                    const int8_t* __restrict__ a_hi, long long lda,
                    const uint32_t* __restrict__ b, int N,
                    const uint32_t* __restrict__ add,
                    uint32_t* __restrict__ out, long long M, int K) {
  __shared__ __align__(16) int32_t a_s[BK][BM];
  __shared__ __align__(16) uint32_t b_s[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;

  uint32_t acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // a: 128 rows x 8 words; consecutive threads take consecutive rows, so
    // the transposed shared-memory stores do not collide
    for (int i = tid; i < BM * (BK / 4); i += kThreads) {
      const int r = i % BM, wq = i / BM;
      const int k = k0 + wq * 4;
      int32_t v[4] = {0, 0, 0, 0};
      if (m0 + r < M && k < K) load4<PAIR>(a_lo, a_hi, (m0 + r) * lda + k, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) a_s[wq * 4 + j][r] = k + j < K ? v[j] : 0;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN, n = i % BN;
      b_s[kk][n] = (k0 + kk < K && n0 + n < N)
                       ? b[static_cast<long long>(k0 + kk) * N + n0 + n] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const int4 a0 = *reinterpret_cast<const int4*>(&a_s[kk][ty * 4]);
      const int4 a1 = *reinterpret_cast<const int4*>(&a_s[kk][64 + ty * 4]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&b_s[kk][tx * 4]);
      const uint4 b1 = *reinterpret_cast<const uint4*>(&b_s[kk][64 + tx * 4]);
      const uint32_t av[8] = {
          static_cast<uint32_t>(a0.x), static_cast<uint32_t>(a0.y),
          static_cast<uint32_t>(a0.z), static_cast<uint32_t>(a0.w),
          static_cast<uint32_t>(a1.x), static_cast<uint32_t>(a1.y),
          static_cast<uint32_t>(a1.z), static_cast<uint32_t>(a1.w)};
      const uint32_t bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bw[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[m * N + n] = acc[i][j] + (add ? add[n] : 0u);
    }
  }
}

template <bool PAIR>
cudaError_t launch(const int8_t* a_lo, const int8_t* a_hi, long long lda,
                   const uint32_t* b, int N, long long b_batch_stride,
                   const uint32_t* add, uint32_t* out, long long M, int K,
                   long long rows_per_batch, int nbatch, cudaStream_t stream) {
  if (N > 8) {
    if (nbatch != 1) return cudaErrorInvalidValue;
    const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
    dot_i8_tiled_kernel<PAIR><<<grid, kThreads, 0, stream>>>(
        a_lo, a_hi, lda, b, N, add, out, M, K);
    return cudaGetLastError();
  }
  // the last batch also takes the M - nbatch * rows_per_batch rows left over
  const long long longest = M - (nbatch - 1) * rows_per_batch;
  const dim3 grid(static_cast<unsigned>((longest + kRows - 1) / kRows), nbatch);
#define SDK_ROWS(NC)                                                       \
  dot_i8_rows_kernel<PAIR, NC><<<grid, kThreads, 0, stream>>>(             \
      a_lo, a_hi, lda, b, N, b_batch_stride, add, out, M, K,               \
      rows_per_batch, nbatch)
  if (N == 1) SDK_ROWS(1);
  else if (N == 2) SDK_ROWS(2);
  else if (N <= 4) SDK_ROWS(4);
  else SDK_ROWS(8);
#undef SDK_ROWS
  return cudaGetLastError();
}

}  // namespace

// a_lo, a_hi: (M, K) int8 with row stride lda bytes (a_hi null: one plane;
// else a = a_lo + (a_hi << 7)); b: nbatch operands of (K, N) uint32,
// b_batch_stride words apart; add: (nbatch * N) uint32 or null; out: (M, N)
// uint32. nbatch == 1: out = a @ b + add. nbatch > 1 (N <= 8 only): rows
// [q * rows_per_batch, ...) use operand q, the last batch to row M.
extern "C" int sdk_dp_dot_i8(const void* a_lo, const void* a_hi,
                             long long lda, const void* b, int N,
                             long long b_batch_stride, const void* add,
                             void* out, long long M, int K,
                             long long rows_per_batch, int nbatch,
                             void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || nbatch <= 0 || lda % 4 != 0 ||
      lda < (K + 3) / 4 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lo = static_cast<const int8_t*>(a_lo);
  const auto* hi = static_cast<const int8_t*>(a_hi);
  const auto* bb = static_cast<const uint32_t*>(b);
  const auto* ad = static_cast<const uint32_t*>(add);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      hi ? launch<true>(lo, hi, lda, bb, N, b_batch_stride, ad, o, M, K,
                        rows_per_batch, nbatch, s)
         : launch<false>(lo, hi, lda, bb, N, b_batch_stride, ad, o, M, K,
                         rows_per_batch, nbatch, s);
  return static_cast<int>(rc);
}
