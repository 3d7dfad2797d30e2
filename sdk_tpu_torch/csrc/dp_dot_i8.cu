// DoublePIR's int8 DB products (kernel K): (M, K) int8 @ (K, N) uint32 ->
// (M, N) uint32, exact mod 2^32, plus a constant row added to every output
// row.
//
// Replaces sdk_tpu/doublepir/server_jax.py:52 _dot_i8_u32 and :90
// _dot_i8pair_u32, with the `c * colsum(b)` rows of :248 and :457 and the
// diagonal row-batch select of :458. The JAX program splits b into five
// 7-bit limb planes because the MXU multiplies int8 only, and needs
// 128 * 127 * K < 2^31 for its int32 partial sums. Here no form has a bound
// on K.
//
// The pair form takes a digit operand below 512 stored as two int8 planes,
// a = a_lo + (a_hi << 7) with a_lo in [0, 128) and a_hi in [0, 4).
//
// Three kernels:
//
// * select (the answer's level 1: one plane, one column a row batch; entry
//   sdk_dp_dot_i8_select). The rows are cut into `nbatch` row batches (the
//   last takes the remainder) and batch q multiplies only its own column,
//   given as row q of a transposed (nbatch, K) operand: per row only the
//   column its batch selects, in one pass over the DB. A block takes 8
//   rows; its 256 threads stride over K four bytes at a time, so a warp
//   reads 128 contiguous bytes of each row, keep 8 sums in registers and
//   reduce them with shuffles at the end. A CUDA core multiplies 32 bits
//   natively: acc += (uint32_t)(int32_t)a * b wraps mod 2^32, one IMAD per
//   product. Bound by bytes: the 8.59 GB DB is read once; one PRMT and one
//   IMAD per byte stay under it.
//
// * tiled (N > 8: the hint setup, DB @ A1 and digits @ A2; entry
//   sdk_dp_dot_i8_tiled) and narrow (N <= 8: the answer's hint product a_2
//   = digits @ q2; entry sdk_dp_dot_i8_narrow). Both on the int8 tensor
//   cores, as the JAX program runs on the MXU, but with byte planes of the
//   u32 operand in place of its 7-bit limbs: b = sum_j 2^(8j) b_j, b_j in
//   [0, 256), and
//       out = sum_j (a @ b_j) << 8j + add     (mod 2^32),
//   one mma.sync.m16n8k32 s8 x u8 -> s32 product a plane. The pair form
//   writes a = a' + 256 x with a' = a mod 256 as s8 (the bytes a_lo |
//   (a_hi & 1) << 7) and x = (a_hi + 1) >> 1 in [0, 2]; x @ b_j lands at
//   shift 8(j + 1), so it goes into plane j + 1's accumulator and x @ b_3
//   (shift 32) vanishes: 7 products where two planes of `a` would take 8.
//   What the two share:
//   - No prep pass for b: a B fragment register of m16n8k32 holds 4
//     neighbouring k of one column, so the four u32 words (k .. k+3, n) of
//     b hold exactly the four planes' registers; 8 PRMTs transpose them
//     (byte_planes). b is staged as it is, as u32 words, with cp.async.
//   - k order: the MMA's sum does not care which k sits in which slot, as
//     long as A and B agree, so a lane's A registers a0 / a2 and B
//     registers b0 / b1 take 8 neighbouring k, and a lane reads each row's
//     A bytes with one wide load.
//   - Exact for any K: one k adds at most 128 * 255 = 32,640 in size to an
//     accumulator in both forms (a' * b_(j+1) + x * b_j in the pair form),
//     so an s32 accumulator is exact over 65,536 k. Nothing relies on the
//     MMA's s32 overflow.
//
//   The tiled form is bound by operations: 4 x 2MNK int8 operations (35.6
//   ms at 1,979 TOP/s for the production H1, M 92,681, K 92,683, N 1,024),
//   then by A1's re-reads. What its design does about each:
//   - lane t's A registers a0 / a2 and B registers b0 / b1 take k 8t ..
//     8t+3 / 8t+4 .. 8t+7 of a k32 step: one 8-byte load a row.
//   - Shared memory: A as [k32 step][BM rows][32 bytes], conflict-free for
//     the 8-byte fragment loads; b as [k][BN words] with each 16-byte chunk
//     c of row k stored at chunk c ^ 2((k >> 3) & 3), so the 32 lanes'
//     word loads of one k hit 32 banks.
//   - The accumulators restart every 2,048 k32 steps and each run is folded
//     into the output with wrapping u32 adds (the first fold stores add +
//     the run, the later ones add to what the block stored).
//   - Registers: a warp tile is 64 rows x 16 u32 columns, 4 m16 x 2 n8
//     tiles x 4 planes x 4 s32 = 128 accumulator registers; 8 warps side
//     by side along N make a 64 x 128 block tile, one block an SM, two
//     cp.async stages of 128 k (a sweep of 128 x 64 and 256 x 32 block
//     tiles and of 3 and 4 stages found none faster).
//   - A1's re-reads: each block reads its 64 rows of `a` and 128 columns
//     of b over all K. Blocks go in order n tile fastest, so the blocks
//     that run together share the DB's rows and b's k-slices through the
//     50 MB L2 (an analytic model of the schedule's HBM bytes:
//     chip_smoke.tiled_hbm_bytes).
//
//   The narrow form is bound by bytes: a_2 reads 4,096 x 92,682 bytes of
//   each digit plane (760 MB, 0.227 ms at 3.35 TB/s) for 7 products a
//   (m16 tile, k32 step), 42.5 G int8 operations (0.021 ms). What its
//   design does about it:
//   - n8 is the batch: the N <= 8 columns are one n8 tile, the columns past
//     N zero in the B registers; nothing is computed for wider tiles.
//   - A block takes 128 rows and one split of K; the grid is (K splits) x
//     (row groups), the splits sized from the occupancy query so that one
//     wave covers the card (one block an SM: 4 splits of 23,296 k at a_2),
//     each at most 65,536 k, so one s32 run a split is exact and nothing
//     restarts.
//   - A streams in the fragments' order, in units of 256 k (four 64-k
//     parts): lane (g, t) copies 16 bytes at k 64c + 16t of rows g and
//     g + 8 of each of its warp's tiles in each plane, so a warp's copy
//     covers 64 contiguous bytes of 8 rows, and a unit's copies runs of
//     256 bytes a row; k step h of part c takes bytes 8h .. 8h+7 of them.
//     The HBM streams 256-byte runs of a row far better than the 64 of a
//     lane's single load (tools/row_runs_gpu.py).
//   - Warps: 4 along the rows, 2 m16 tiles (32 rows) each, times 2 along
//     k, each taking two of a unit's four parts: the B registers a warp
//     builds serve two tiles, and the two warps of a row pair add their
//     sums into the output apart.
//   - Each copy carries the L2 prefetch hint of 256 bytes (cp.async ...
//     .L2::256B), so the HBM serves a unit's runs in pieces of 256 bytes,
//     not in the 64 of a warp's copy (tools/row_runs_gpu.py measures
//     both).
//   - The copies go through a ring of 3 units in shared memory (cp.async,
//     64 KB of A a unit, two units in flight ahead of the MMAs); each
//     thread reads back only its own A pieces. A unit of 256 rows would
//     take 128 KB, more than a ring of them fits: so 128 rows a block.
//   - b is read once a block: each unit's 256 k of it are staged in the
//     unit's slot for all the block's warps as [k][8] words, the columns
//     past N zero and the rows of each aligned four rotated by (k >> 4) &
//     3, so a warp's word loads of one k step hit 32 banks. The L2 reads of
//     b are 4 N / 256 of A's bytes (12.5% at N = 8).
//   - The splits' sums are combined with wrapping atomicAdds into an
//     output the entry zeroes with a memset on the same stream, the add row
//     added by split 0; sums mod 2^32 do not depend on order.
//
// Rows of `a` start on 4-byte boundaries (lda % 4 == 0, lda >= K rounded up
// to 4) for the select kernel, on 16-byte boundaries (lda % 16 == 0, lda >=
// K rounded up to 16) for the tensor-core ones; bytes past K in a row are
// read and multiplied by zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- the int8 tensor-core arithmetic of the tiled and narrow forms ----

// 16-byte asynchronous copy global -> shared (L2 only); src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N groups of copies are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A (16 x 32 s8, row-major) x B (32 x 8 u8, column-major), in s32.
__device__ __forceinline__ void mma_s8u8(int32_t (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four words w_i = bytes (w_i0 .. w_i3) -> four plane registers p_j =
// (w_0j, w_1j, w_2j, w_3j): byte j of four neighbouring k, in k order.
__device__ __forceinline__ void byte_planes(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3,
                                            uint32_t (&p)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);   // w00 w10 w01 w11
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);   // w02 w12 w03 w13
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  p[0] = __byte_perm(t0, t2, 0x5410);
  p[1] = __byte_perm(t0, t2, 0x7632);
  p[2] = __byte_perm(t1, t3, 0x5410);
  p[3] = __byte_perm(t1, t3, 0x7632);
}

// The pair form's A registers: a = lo + 128 hi = a' + 256 x, four bytes a
// register; a (the lo bytes) becomes a' = a mod 256 as s8, x in [0, 2].
__device__ __forceinline__ void pair_split(uint32_t (&a)[4],
                                           const uint32_t (&hw)[4],
                                           uint32_t (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] |= (hw[e] & 0x01010101u) << 7;
    x[e] = ((hw[e] + 0x01010101u) >> 1) & 0x7F7F7F7Fu;
  }
}

// ---- the select form, on the CUDA cores ----

constexpr int kThreads = 256;
constexpr int kRows = 8;      // rows per block of the select kernel
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

// out[r, c] = sum_k a[r, k] * b_q[k, c] + add[q * N + c] for the rows r of
// batch q = blockIdx.y, where b_q = b + q * b_batch_stride is (K, N); the
// select entry runs it with N = 1 (the batch's column, b_batch_stride = K).
// N and the stride stay runtime parameters: a form with N fixed at 1 and
// b_q[k] indexed directly compiled to a loop that streamed the DB ~8%
// slower (tools/scan_bench_gpu.py --kernel answer, level1).
__global__ void __launch_bounds__(kThreads)
dot_i8_select_kernel(const int8_t* __restrict__ a, long long lda,
                     const uint32_t* __restrict__ b, int N,
                     long long b_batch_stride,
                     const uint32_t* __restrict__ add,
                     uint32_t* __restrict__ out, long long M, int K,
                     long long rows_per_batch, int nbatch) {
  constexpr int NC = 1;
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

  const int kwords = (K + 3) / 4;
  for (int kw = threadIdx.x; kw < kwords; kw += kThreads) {
    const int k = kw * 4;
    uint32_t bv[4][NC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        bv[j][c] = (c < N && k + j < K)
                       ? bq[static_cast<long long>(k + j) * N + c] : 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        int32_t v[4];
        unpack4(*reinterpret_cast<const uint32_t*>(a + (row0 + r) * lda + k),
                v);
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

// ---- the tiled form, on the int8 tensor cores ----

constexpr int kTiledThreads = 256;   // 8 warps, side by side along N
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kMT = 4;               // m16 tiles of a warp (64 rows)
constexpr int kNT = 2;               // n8 tiles of a warp (16 u32 columns)
constexpr int BM = 16 * kMT;         // block tile: 64 rows
constexpr int BN = 8 * kNT * kTiledWarps;   // x 128 u32 columns
constexpr int kStepK = 32;           // k of one MMA step
constexpr int kStageSteps = 4;       // k32 steps of one pipeline stage
constexpr int kStageK = kStepK * kStageSteps;
constexpr int kStages = 2;           // cp.async stages
constexpr int kRestartSteps = 2048;  // k32 steps between restarts (65,536 k)
static_assert(kRestartSteps % kStageSteps == 0, "restart on a stage edge");
static_assert(BN / 4 >= 8, "the chunk swizzle needs 8 chunks a row");

struct TiledArgs {
  const int8_t* a_lo;
  const int8_t* a_hi;
  long long lda;       // bytes between rows of a_lo / a_hi
  const uint32_t* b;
  long long ldb;       // words between rows of b (a multiple of 4, >= N)
  const uint32_t* add;
  uint32_t* out;       // (M, N), row stride N
  long long M;
  int N, K;
  int n_tiles;         // ceil(N / BN)
};

// Shared memory of one pipeline stage: A (and A_hi) as [k32 step][BM][32
// bytes], then b as [kStageK][BN] words.
constexpr int kABytes = BM * kStageK;
template <bool PAIR>
constexpr int kStageBytes = (PAIR ? 2 : 1) * kABytes + kStageK * BN * 4;

// The chunk of row k of the b stage that holds chunk c: c ^ 2((k >> 3) & 3).
__device__ __forceinline__ int b_chunk(int k, int c) {
  return c ^ (((k >> 3) & 3) << 1);
}

// Fold the accumulators of one run into the block's outputs: out = add +
// run at the first fold, out += run after it; every sum wraps mod 2^32.
// Lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each tile.
__device__ __forceinline__ void fold_run(const int32_t (&acc)[kMT][kNT][4][4],
                                         const TiledArgs& p, long long m0,
                                         int n0, bool first) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + 16 * i + g + 8 * h;
      if (m >= p.M) continue;
      uint32_t* row = p.out + m * p.N;
#pragma unroll
      for (int u = 0; u < kNT; ++u) {
        const int n = n0 + 8 * u + 2 * t;
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[e] += static_cast<uint32_t>(acc[i][u][j][2 * h + e]) << (8 * j);
        }
        if (pairs && n + 1 < p.N) {
          uint2* dst = reinterpret_cast<uint2*>(row + n);
          uint2 base;
          if (first) {
            base = p.add ? make_uint2(p.add[n], p.add[n + 1]) : make_uint2(0, 0);
          } else {
            base = *dst;
          }
          *dst = make_uint2(base.x + v[0], base.y + v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < p.N) {
              const uint32_t base =
                  first ? (p.add ? p.add[n + e] : 0u) : row[n + e];
              row[n + e] = base + v[e];
            }
        }
      }
    }
}

// out[m, n] = sum_k a[m, k] * b[k, n] + add[n] for one BM x BN tile a block.
template <bool PAIR>
__global__ void __launch_bounds__(kTiledThreads, 1)
dot_i8_tiled_kernel(const TiledArgs p) {
  constexpr int kStage = kStageBytes<PAIR>;
  extern __shared__ __align__(16) uint8_t smem[];

  // block -> (m tile, n tile), n tiles fastest
  const long long m0 = static_cast<long long>(blockIdx.x / p.n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * BN;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = warp * 8 * kNT;       // the warp's columns in the tile

  // the copies of one stage (a_lo's and a_hi's BM rows x kStageK bytes, b's
  // kStageK rows x BN words; rows past M, k past K and columns past ldb
  // read as zeros): a thread's A pieces lie in one 16-byte column of the
  // stage, kAR rows apart, its b chunks in one chunk column, kBR rows apart
  constexpr int kP = kStageK / 16;          // A pieces a row
  constexpr int kAR = kTiledThreads / kP;
  constexpr int kBC = BN / 4;               // b chunks a row
  constexpr int kBR = kTiledThreads / kBC;
  static_assert(BM % kAR == 0 && kStageK % kBR == 0, "whole copy rounds");
  const int a_row = tid / kP, a_piece = tid % kP;
  const int b_row = tid / kBC, b_c = tid % kBC;
  const long long a_off = (m0 + a_row) * p.lda + 16 * a_piece;
  const int a_dst = ((a_piece >> 1) * BM + a_row) * kStepK + 16 * (a_piece & 1);
  const bool b_col_ok = n0 + 4 * b_c < p.ldb;
  const uint32_t* b_src = p.b + b_row * p.ldb + n0 + 4 * b_c;

  auto load_stage = [&](int slot, int kt) {
    uint8_t* st = smem + static_cast<size_t>(slot) * kStage;
    const int k0 = kt * kStageK;
    const bool a_k_ok = k0 + 16 * a_piece < p.K;
#pragma unroll
    for (int plane = 0; plane < (PAIR ? 2 : 1); ++plane) {
      const int8_t* src = (plane ? p.a_hi : p.a_lo) + a_off + k0;
      uint8_t* dst = st + plane * kABytes + a_dst;
#pragma unroll
      for (int q = 0; q < BM / kAR; ++q) {
        const bool ok = a_k_ok && m0 + a_row + q * kAR < p.M;
        cp_async16(dst + q * kAR * kStepK, ok ? src : p.a_lo, ok ? 16 : 0);
        src += kAR * p.lda;
      }
    }
    uint32_t* bs =
        reinterpret_cast<uint32_t*>(st + (PAIR ? 2 : 1) * kABytes);
    const uint32_t* src = b_src + k0 * p.ldb;
#pragma unroll
    for (int q = 0; q < kStageK / kBR; ++q) {
      const int kk = b_row + q * kBR;
      const bool ok = b_col_ok && k0 + kk < p.K;
      cp_async16(bs + kk * BN + 4 * b_chunk(kk, b_c), ok ? src : p.b,
                 ok ? 16 : 0);
      src += kBR * p.ldb;
    }
  };

  // fragment offsets in a stage: lane (g, t) reads the b words k = 8t .. 8t+7
  // (+ 32 a step) of column nw + 8u + g, whose chunk row k swizzles by
  // 2((k >> 3) & 3) = 2t, and the A rows g (+ 16i, + 8) at byte 8t
  int b_ofs[kNT];
#pragma unroll
  for (int u = 0; u < kNT; ++u) {
    const int n = nw + 8 * u + g;
    b_ofs[u] = 8 * t * BN + 4 * ((n >> 2) ^ (t << 1)) + (n & 3);
  }
  const int a_ofs = g * kStepK + 8 * t;

  int32_t acc[kMT][kNT][4][4];
  const int n_kt = (p.K + kStageK - 1) / kStageK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    cp_async_commit();
  }
  // runs of kRestartSteps k32 steps, each folded into the outputs
  constexpr int kRunStages = kRestartSteps / kStageSteps;
  for (int kt0 = 0; kt0 < n_kt; kt0 += kRunStages) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int u = 0; u < kNT; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][u][j][e] = 0;
    const int kt1 = min(n_kt, kt0 + kRunStages);
    for (int kt = kt0; kt < kt1; ++kt) {
      cp_async_wait<kStages - 2>();   // stage kt has landed
      __syncthreads();                // and every warp is done with kt - 1
      const int nxt = kt + kStages - 1;
      if (nxt < n_kt) load_stage(nxt % kStages, nxt);
      cp_async_commit();

      const uint8_t* st = smem + static_cast<size_t>(kt % kStages) * kStage;
      const uint32_t* bs =
          reinterpret_cast<const uint32_t*>(st + (PAIR ? 2 : 1) * kABytes);
#pragma unroll
      for (int ks = 0; ks < kStageSteps; ++ks) {
        // the four planes' B registers of the warp's n8 tiles: lane (g, t)
        // takes column g, k 8t .. 8t+3 (b0) and 8t+4 .. 8t+7 (b1)
        uint32_t bp[kNT][4][2];
#pragma unroll
        for (int u = 0; u < kNT; ++u) {
          uint32_t w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = bs[b_ofs[u] + (ks * kStepK + i) * BN];
          uint32_t lo[4], hi[4];
          byte_planes(w[0], w[1], w[2], w[3], lo);
          byte_planes(w[4], w[5], w[6], w[7], hi);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            bp[u][j][0] = lo[j];
            bp[u][j][1] = hi[j];
          }
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          // rows g and g + 8 of m16 tile i, k 8t .. 8t+7: registers a0 / a2
          // and a1 / a3
          const uint8_t* ap = st + ks * BM * kStepK + a_ofs + 16 * i * kStepK;
          const uint2 r0 = *reinterpret_cast<const uint2*>(ap);
          const uint2 r1 = *reinterpret_cast<const uint2*>(ap + 8 * kStepK);
          uint32_t a[4] = {r0.x, r1.x, r0.y, r1.y};
          if constexpr (PAIR) {
            const uint2 h0 = *reinterpret_cast<const uint2*>(ap + kABytes);
            const uint2 h1 =
                *reinterpret_cast<const uint2*>(ap + kABytes + 8 * kStepK);
            const uint32_t hw[4] = {h0.x, h1.x, h0.y, h1.y};
            uint32_t x[4];
            pair_split(a, hw, x);
#pragma unroll
            for (int u = 0; u < kNT; ++u)
#pragma unroll
              for (int j = 0; j < 3; ++j)
                mma_s8u8(acc[i][u][j + 1], x, bp[u][j][0], bp[u][j][1]);
          }
#pragma unroll
          for (int u = 0; u < kNT; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_s8u8(acc[i][u][j], a, bp[u][j][0], bp[u][j][1]);
        }
      }
    }
    fold_run(acc, p, m0, n0 + nw, kt0 == 0);
  }
  cp_async_wait<0>();
}

template <bool PAIR>
cudaError_t launch_tiled(TiledArgs p, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kStages) * kStageBytes<PAIR>;
  p.n_tiles = (p.N + BN - 1) / BN;
  const long long blocks = (p.M + BM - 1) / BM * p.n_tiles;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dot_i8_tiled_kernel<PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dot_i8_tiled_kernel<PAIR>
      <<<static_cast<unsigned>(blocks), kTiledThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---- the narrow form (N <= 8), on the int8 tensor cores ----

constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowMT = 2;         // m16 tiles of a warp
constexpr int kNarrowRowWarps = kNarrowWarps / kNarrowMT;   // along the rows
constexpr int kNarrowRows = 16 * kNarrowMT * kNarrowRowWarps;   // 128 a block
constexpr int kUnitK = 256;          // k of a unit
constexpr int kUnitParts = kUnitK / 64;   // 64-k parts of a unit
constexpr int kWarpParts = kUnitParts / kNarrowMT;   // parts of a unit a warp
constexpr int kRing = 3;             // units of the cp.async ring
constexpr int kMaxRunK = 65536;      // k of one exact s32 run
static_assert(kMaxRunK % kUnitK == 0, "splits end on a unit edge");

// 16-byte loads of a thread a unit: (tile i, plane, row half h, part c)
template <bool PAIR>
constexpr int kUnitLoads = kNarrowMT * (PAIR ? 2 : 1) * 2 * kWarpParts;

// a ring slot: the unit's A pieces [load][thread], then its slice of b as
// [k][8] words
template <bool PAIR>
constexpr size_t kSlotBytes =
    sizeof(uint4) * kUnitLoads<PAIR> * kNarrowThreads +
    sizeof(uint32_t) * kUnitK * 8;
template <bool PAIR>
constexpr size_t kNarrowSmem = kRing * kSlotBytes<PAIR>;
static_assert(kNarrowSmem<true> <= 232448, "one block an SM");

struct NarrowArgs {
  const int8_t* a_lo;
  const int8_t* a_hi;
  long long lda;       // bytes between rows of a_lo / a_hi
  const uint32_t* b;   // (K, N), row stride N
  const uint32_t* add;
  uint32_t* out;       // (M, N), zeroed before the launch
  long long M;
  int N, K;
  int b_vec;           // N % 4 == 0 and b on a 16-byte boundary
  int split_k;         // k of a split: a multiple of kUnitK, <= kMaxRunK
};

// cp_async16 with the L2 prefetch hint of 256 bytes: the HBM serves a
// unit's run of a row in pieces of 256 bytes, not in the 64 of a warp's
// copy.
__device__ __forceinline__ void cp_async16_run(void* dst, const void* src,
                                               int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::
                   "r"(s), "l"(src), "r"(src_bytes));
}

// The row of a slice of b that holds its k: the rows of each aligned four
// rotate by (k >> 4) & 3.
__device__ __forceinline__ int b_row(int k) {
  return (k & ~3) | ((k + (k >> 4)) & 3);
}

// out[m, n] += sum over this block's split of k of a[m, k] * b[k, n] (+
// add[n] in split 0) for the block's 128 rows; blockIdx.x is the split,
// blockIdx.y the row group.
template <bool PAIR>
__global__ void __launch_bounds__(kNarrowThreads, 1)
dot_i8_narrow_kernel(const NarrowArgs p) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int L = kUnitLoads<PAIR>;
  constexpr int P = PAIR ? 2 : 1;
  constexpr int MT = kNarrowMT, PPW = kWarpParts;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp = (kh, row warp): its MT tiles, parts kh * PPW .. of every unit
  const int kh = warp / kNarrowRowWarps;
  const int split = blockIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.y) * kNarrowRows +
                       (warp % kNarrowRowWarps) * 16 * MT;
  const int kbeg = split * p.split_k;
  const int kend = min(p.K, kbeg + p.split_k);
  const int n_units = (kend - kbeg + kUnitK - 1) / kUnitK;

  auto a_slot = [&](int u) {
    return reinterpret_cast<uint4*>(smem + (u % kRing) * kSlotBytes<PAIR>);
  };
  auto b_slot = [&](int u) {
    return reinterpret_cast<uint32_t*>(a_slot(u) + L * kNarrowThreads);
  };

  // load j = ((i * P + plane) * 2 + h) * PPW + cc of a unit: row m0 + 16i
  // + g + 8h, bytes 64c + 16t .. + 15 of the unit's 256 k, c = PPW kh + cc
  const long long lane_off = (m0 + g) * p.lda + kbeg + 64 * PPW * kh + 16 * t;
  unsigned rows_ok = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m0 + 16 * i + g + 8 * h < p.M) rows_ok |= 1u << (2 * i + h);

  // unit u's A pieces and slice of b into its slot: rows past M, k past K
  // and columns past N as zeros
  auto issue = [&](int u) {
    if (u >= n_units) return;
    uint4* dst = a_slot(u) + tid;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int cc = j % PPW, h = (j / PPW) & 1;
      const int plane = (j / (2 * PPW)) % P;
      const int i = j / (2 * PPW * P);
      const int k = u * kUnitK + 64 * cc;
      const bool ok = kbeg + k + 64 * PPW * kh + 16 * t < p.K &&
                      ((rows_ok >> (2 * i + h)) & 1);
      const int8_t* src = (plane ? p.a_hi : p.a_lo) + lane_off +
                          (16 * i + 8 * h) * p.lda + k;
      cp_async16_run(dst + j * kNarrowThreads, ok ? src : p.a_lo,
                     ok ? 16 : 0);
    }
    uint32_t* bs = b_slot(u);
    const int k0 = kbeg + u * kUnitK;
    if (p.b_vec) {
      for (int e = tid; e < kUnitK * 2; e += kNarrowThreads) {
        const int kk = e >> 1, ch = e & 1;
        const bool ok = k0 + kk < p.K && 4 * ch < p.N;
        cp_async16(bs + b_row(kk) * 8 + 4 * ch,
                   ok ? p.b + static_cast<long long>(k0 + kk) * p.N + 4 * ch
                      : p.b,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kUnitK * 8; e += kNarrowThreads) {
        const int kk = e >> 3, n = e & 7;
        const bool ok = k0 + kk < p.K && n < p.N;
        cp_async4(bs + b_row(kk) * 8 + n,
                  ok ? p.b + static_cast<long long>(k0 + kk) * p.N + n : p.b,
                  ok ? 4 : 0);
      }
    }
  };

  // word e of k step h of a 64-k part for lane (g, t): k 16t + 8h + e,
  // column g
  int b_ofs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    b_ofs[e] = (16 * t + (e & 4) + ((e + t) & 3)) * 8 + g;

  int32_t acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<kRing - 2>();   // this thread's copies of unit u landed
    __syncthreads();              // every thread's, and unit u - 1 is done
    issue(u + kRing - 1);         // into the slot unit u - 1 used
    cp_async_commit();
    const uint4* as = a_slot(u) + tid;
    const uint32_t* bs = b_slot(u);
#pragma unroll
    for (int cc = 0; cc < PPW; ++cc) {
      const int c = PPW * kh + cc;
      uint4 r[MT][P][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int pl = 0; pl < P; ++pl)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            r[i][pl][h] = as[(((i * P + pl) * 2 + h) * PPW + cc) *
                             kNarrowThreads];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the four planes' B registers of k step h: k 64c + 16t + 8h ..
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) w[e] = bs[512 * c + 64 * h + b_ofs[e]];
        uint32_t lo[4], hi[4];
        byte_planes(w[0], w[1], w[2], w[3], lo);
        byte_planes(w[4], w[5], w[6], w[7], hi);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // rows g and g + 8, k 16t + 8h .. + 7: registers a0 / a2, a1 / a3
          const uint4 r0 = r[i][0][0], r1 = r[i][0][1];
          uint32_t a[4] = {h ? r0.z : r0.x, h ? r1.z : r1.x,
                           h ? r0.w : r0.y, h ? r1.w : r1.y};
          if constexpr (PAIR) {
            const uint4 q0 = r[i][1][0], q1 = r[i][1][1];
            const uint32_t hw[4] = {h ? q0.z : q0.x, h ? q1.z : q1.x,
                                    h ? q0.w : q0.y, h ? q1.w : q1.y};
            uint32_t x[4];
            pair_split(a, hw, x);
#pragma unroll
            for (int j = 0; j < 3; ++j)
              mma_s8u8(acc[i][j + 1], x, lo[j], hi[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8u8(acc[i][j], a, lo[j], hi[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the split's sum into the output: lane (g, t) holds rows g, g + 8 and
  // columns 2t, 2t + 1 of each tile
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + 16 * i + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 2 * t + e;
        if (n >= p.N) continue;
        uint32_t v = split == 0 && kh == 0 && p.add ? p.add[n] : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v += static_cast<uint32_t>(acc[i][j][2 * h + e]) << (8 * j);
        atomicAdd(p.out + m * p.N + n, v);
      }
    }
}

template <bool PAIR>
cudaError_t narrow_blocks_per_sm(int* bps) {
  constexpr size_t smem = kNarrowSmem<PAIR>;
  cudaError_t err = cudaFuncSetAttribute(
      dot_i8_narrow_kernel<PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      bps, dot_i8_narrow_kernel<PAIR>, kNarrowThreads, smem);
}

template <bool PAIR>
cudaError_t launch_narrow(NarrowArgs p, cudaStream_t stream) {
  int bps = 0, dev = 0, sms = 0;
  cudaError_t err = narrow_blocks_per_sm<PAIR>(&bps);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (p.M + kNarrowRows - 1) / kNarrowRows;
  if (groups > 65535) return cudaErrorInvalidValue;
  // splits: one wave of blocks over the row groups, at most 65,536 k each
  const int units = (p.K + kUnitK - 1) / kUnitK;
  long long splits = static_cast<long long>(sms) * bps / groups;
  const long long min_splits = (p.K + kMaxRunK - 1) / kMaxRunK;
  if (splits < min_splits) splits = min_splits;
  if (splits > units) splits = units;
  const int per = static_cast<int>((units + splits - 1) / splits);
  splits = (units + per - 1) / per;
  p.split_k = per * kUnitK;
  err = cudaMemsetAsync(p.out, 0, sizeof(uint32_t) * p.M * p.N, stream);
  if (err != cudaSuccess) return err;
  dot_i8_narrow_kernel<PAIR>
      <<<dim3(static_cast<unsigned>(splits), static_cast<unsigned>(groups)),
         kNarrowThreads, kNarrowSmem<PAIR>, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The select form (the answer's level 1): a (M, K) int8 with row stride lda
// bytes; b: nbatch operands of K uint32, K words apart ((nbatch, K), row q
// the column batch q selects); add: nbatch uint32 or null; out: (M,)
// uint32. Rows [q * rows_per_batch, ...) use operand q, the last batch to
// row M: out[r] = sum_k a[r, k] * b[q, k] + add[q].
extern "C" int sdk_dp_dot_i8_select(const void* a, long long lda,
                                    const void* b, const void* add, void* out,
                                    long long M, int K,
                                    long long rows_per_batch, int nbatch,
                                    void* stream) {
  if (M <= 0 || K <= 0 || nbatch <= 0 || rows_per_batch <= 0 ||
      lda % 4 != 0 || lda < (K + 3) / 4 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // the last batch also takes the M - nbatch * rows_per_batch rows left over
  const long long longest = M - (nbatch - 1) * rows_per_batch;
  const dim3 grid(static_cast<unsigned>((longest + kRows - 1) / kRows), nbatch);
  dot_i8_select_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), lda, static_cast<const uint32_t*>(b), 1,
      K, static_cast<const uint32_t*>(add), static_cast<uint32_t*>(out), M, K,
      rows_per_batch, nbatch);
  return static_cast<int>(cudaGetLastError());
}

// The tiled form: out (M, N) = a @ b + add, a_lo / a_hi (M, K) int8 with
// row stride lda bytes (lda % 16 == 0, >= K rounded up to 16; a_hi null:
// one plane; else a = a_lo + (a_hi << 7), a_lo in [0, 128), a_hi in
// [0, 4)), b (K, N) uint32 with row stride ldb words (ldb % 4 == 0, >= N;
// columns N .. ldb zero), every operand on a 16-byte boundary; add (N)
// uint32 or null. Block tiles of 64 rows x 128 columns.
extern "C" int sdk_dp_dot_i8_tiled(const void* a_lo, const void* a_hi,
                                   long long lda, const void* b,
                                   long long ldb, int N, const void* add,
                                   void* out, long long M, int K,
                                   void* stream) {
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  if (M <= 0 || K <= 0 || N <= 0 || lda % 16 != 0 ||
      lda < (K + 15) / 16 * 16 || ldb % 4 != 0 || ldb < N ||
      !aligned(a_lo) || !aligned(b) ||
      (a_hi && !aligned(a_hi)))
    return static_cast<int>(cudaErrorInvalidValue);
  TiledArgs p{};
  p.a_lo = static_cast<const int8_t*>(a_lo);
  p.a_hi = static_cast<const int8_t*>(a_hi);
  p.lda = lda;
  p.b = static_cast<const uint32_t*>(b);
  p.ldb = ldb;
  p.add = static_cast<const uint32_t*>(add);
  p.out = static_cast<uint32_t*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      a_hi ? launch_tiled<true>(p, s) : launch_tiled<false>(p, s);
  return static_cast<int>(rc);
}

// The narrow form: out (M, N) = a @ b + add for N <= 8, a_lo / a_hi as
// the tiled form's (rows on 16-byte boundaries, lda % 16 == 0, >= K
// rounded up to 16), b (K, N) uint32 with row stride N, add (N) uint32 or
// null, out (M, N) uint32: the entry zeroes it on the stream, then the
// launch's K splits add into it.
extern "C" int sdk_dp_dot_i8_narrow(const void* a_lo, const void* a_hi,
                                    long long lda, const void* b, int N,
                                    const void* add, void* out, long long M,
                                    int K, void* stream) {
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  if (M <= 0 || K <= 0 || N <= 0 || N > 8 || lda % 16 != 0 ||
      lda < (K + 15) / 16 * 16 || !aligned(a_lo) || (a_hi && !aligned(a_hi)) ||
      (reinterpret_cast<uintptr_t>(b) & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowArgs p{};
  p.a_lo = static_cast<const int8_t*>(a_lo);
  p.a_hi = static_cast<const int8_t*>(a_hi);
  p.lda = lda;
  p.b = static_cast<const uint32_t*>(b);
  p.add = static_cast<const uint32_t*>(add);
  p.out = static_cast<uint32_t*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.b_vec = N % 4 == 0 && aligned(b);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      a_hi ? launch_narrow<true>(p, s) : launch_narrow<false>(p, s);
  return static_cast<int>(rc);
}

// Blocks of the narrow form an SM (the occupancy query its grid is sized
// from), one plane or the pair; negative on an error.
extern "C" int sdk_dp_dot_i8_narrow_occupancy(int pair) {
  int bps = 0;
  const cudaError_t err = pair ? narrow_blocks_per_sm<true>(&bps)
                               : narrow_blocks_per_sm<false>(&bps);
  return err == cudaSuccess ? bps : -static_cast<int>(err);
}

namespace {

// One warp, `steps` m16n8k32 s8 x u8 products of a = 127 and b = 255 into
// one set of s32 accumulators that never restart: 1,036,320 a product,
// past 2^31 from step 2,073. out[lane * 4 + e] = accumulator e.
__global__ void mma_wrap_probe_kernel(int32_t* out, int steps) {
  int32_t acc[4] = {0, 0, 0, 0};
  const uint32_t a[4] = {0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu, 0x7F7F7F7Fu};
  for (int s = 0; s < steps; ++s) mma_s8u8(acc, a, 0xFFFFFFFFu, 0xFFFFFFFFu);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[threadIdx.x * 4 + e] = acc[e];
}

}  // namespace

// Whether the s32 accumulation of mma.sync wraps or saturates (a card
// test's probe; kernel K never lets its accumulators leave int32): out is
// (32, 4) int32.
extern "C" int sdk_dp_mma_wrap_probe(void* out, int steps, void* stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  mma_wrap_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
