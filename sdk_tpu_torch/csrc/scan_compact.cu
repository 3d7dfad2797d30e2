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
// word. The limb split and the int32 weight-group sums are the dense scan's
// (scan_common.cuh; the int32 bound holds because cap <= 2^15).
//
// Layout: int32 words (crt, Z, L=4, CW=cap/4, M), M = IT * num_per with the
// bin minor (IT = instances * trials rows a bin), one word = limb k of the
// four slots 4cw .. 4cw+3 of row m; idx_j is (num_per, cap) int32.
//
// Tensor cores, tiled by bin. The gathered query columns of a k32 step (32
// slots) are the same for every row of one bin, so an m16n8k32 MMA
// (s8 x s8 -> s32, the PTX fragment layouts of csrc/scan.cu) takes 16 rows
// of ONE bin: A row g is bin row i = 16 mt + g, i.e. m = i * num_per + b, and
// register a0 of lane (g, t) is the DB word (slot word 8 ks + t, row i), a1
// row i + 8, a2 / a3 slot word 8 ks + 4 + t; rows past IT are not stored. B
// (32 slots x 8 columns) register b0 of lane (g, t) holds limb l of the query
// at the four slots 32 ks + 4t .. +3 of column g, gathered through idx_j; b1
// the slots 16 further; zero for slots past cap, whose A words are not
// copied.
//
// A block owns one (channel, z), a block of rb columns and gpb groups of
// bs neighbouring bins. The rows of a bin lie num_per words apart, so a
// warp loading its own fragments would touch 32 sectors for 128 useful
// bytes. Instead the block stages, per (bin group, m16 tile, k32 step),
// 4 limbs x sw slot words x 16 rows x bs bins (16 KB: sw = 8, bs = 8 for
// caps above 16; sw = 4, bs = 16 at cap 16 and sw = 2, bs = 32 at cap 8,
// whose one k32 step has only sw words) and their idx_j, with 16-byte
// cp.async copies of 4 neighbouring bins of one row (a warp copies whole
// sectors; at bs = 32 whole 128-byte lines), ns stages deep (ns - 1 steps in
// flight). Warp w takes bins w, w + 8, .. of a group one after another (bs
// / 8 of them; above 8 a bin has one k32 step, so its sums end with it).
// 4-byte copies ran at half the rate of the dense scan's 4-byte loads on
// the H100 (PERF.md), and are kept only for an index whose rows are not
// 16-byte aligned (num_per % 4 != 0). The stage is laid out (limb, word,
// row, bin), the 16-byte chunks of a row permuted by its row bits, so that
// the fragment reads of one bin hit 8 banks (4-way at bs 8 and 16; its bin
// sits at one place of each chunk) and a quarter warp's 16-byte copies 8.
//
// The query is packed once per block: W[j][col] = the four 7-bit limbs of
// Q[j, col0 + col] in one word, for all dim0 rows j and the block's rb
// columns (zero past R), rows padded by one word at rb >= 8 against bank
// conflicts. A lane gathers its B words from W[idx_j[b, s]][8u + g] for its
// four slots and turns them into the four limbs' words with a 4x4 byte
// transpose (8 __byte_perm), once per (bin, step, 8-column tile, half).
//
// Epilogue: sum_s S_s * (2^{7s} mod q) in 64 bits (7 wide multiply-adds),
// reduced mod q by Shoup's method on its two 32-bit halves with constants
// from the host, instead of a 64-bit % by a runtime divisor.
//
// What bounds it on the H100: bytes at a single read (2.15 GB of compact
// index at cap 128, 0.66 ms at 3.35 TB/s); at R = 32 the MMAs (16 a tile
// per bin and k32 step) and the epilogue (7 weight groups per output) come
// on top of the bytes. Measured on an H100 80GB HBM3 at 700 W
// (tools/scan_bench_gpu.py --kernel compact, PERF.md): the S2 index at
// R = 32 in 2.70 ms (33% of its bound; torch._int_mm over the same bytes at
// 32 columns 4.49 ms), at R = 2 in 1.09-1.11 ms (60%). A block's step is a
// serial chain (copy wait, barrier, fragment reads, gather, MMAs, epilogue)
// that 8 (R = 32) or 16 (R = 2) warps an SM share; no wgmma or TMA yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan_common::kEpi;
using scan_common::kLimbs;
using scan_common::kWeights;
using scan_common::recombine;

constexpr int kThreads = 256;     // 8 warps

constexpr int kDbWords = 4096;    // DB words of a stage (16 KB)

// The shape of a stage: SW slot words (2, 4 or 8) of kBs = 64 / SW bins.
template <int SW>
struct Shape {
  static constexpr int kBs = 64 / SW;
  static constexpr int kLbs = SW == 8 ? 3 : SW == 4 ? 4 : 5;  // log2(kBs)
  static constexpr int kWords = kDbWords + 32 * kBs;
  // stage word of (limb k, step word cw, tile row i, bin b): 16-byte chunk
  // b / 4 of the row at b / 4 ^ (i >> (5 - kLbs)) & (kBs / 4 - 1)
  __device__ static __forceinline__ int at(int k, int cw, int i, int b) {
    const int swz = (i >> (5 - kLbs)) & ((kBs >> 2) - 1);
    return ((k * SW + cw) * 16 + i) * kBs +
           ((((b >> 2) ^ swz) << 2) | (b & 3));
  }
};

struct Tiling {
  int Z, M, NPR, CW, DIM0, R;
  int rb;   // columns of a block (W columns)
  int ncb;  // column blocks
  int gpb;  // bin groups of a block
  int ns;   // stages (2 to 4): ns - 1 steps' copies in flight
  int vec;  // 1: 16-byte copies (rows 16-byte aligned), 0: 4-byte copies
  uint32_t q[2];
  uint32_t w[2][kEpi];  // the epilogue constants of each channel
};

// d += A (16 x 32, row-major) x B (32 x 8, column-major), int8 -> int32.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// 16-byte asynchronous copy global -> shared (L2 only).
__device__ __forceinline__ void cp_async16(uint32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ns - 2 groups of copies are pending.
__device__ __forceinline__ void cp_async_wait(int ns) {
  if (ns >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (ns == 3)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Byte l of w0..w3 -> word l (limb l of four slots).
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&o)[kLimbs]) {
  const uint32_t a = __byte_perm(w0, w1, 0x5140);
  const uint32_t b = __byte_perm(w0, w1, 0x7362);
  const uint32_t e = __byte_perm(w2, w3, 0x5140);
  const uint32_t f = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(a, e, 0x5410);
  o[1] = __byte_perm(a, e, 0x7632);
  o[2] = __byte_perm(b, f, 0x5410);
  o[3] = __byte_perm(b, f, 0x7632);
}

template <int NTW, int SW>
__global__ void __launch_bounds__(kThreads)
scan_compact_kernel(const int32_t* __restrict__ db,
                    const int32_t* __restrict__ idx_j,
                    const uint32_t* __restrict__ query,
                    uint32_t* __restrict__ out, const Tiling p) {
  extern __shared__ __align__(16) uint32_t smem[];
  using sh = Shape<SW>;
  constexpr int bs = sh::kBs, lbs = sh::kLbs, stw = sh::kWords;
  uint32_t* stage = smem;                        // [ns][stw]
  uint32_t* wts = smem + p.ns * stw;             // [kEpi]
  uint32_t* W = wts + 16;                        // [DIM0][ld]

  const int c = blockIdx.z / p.ncb;
  const int col0 = (blockIdx.z % p.ncb) * p.rb;
  const int z = blockIdx.y;
  const uint32_t q = p.q[c];
  const int M = p.M, NPR = p.NPR, CW = p.CW, R = p.R, rb = p.rb;
  const int IT = M / NPR;
  const int cap = 4 * CW;
  const int ld = rb >= 8 ? rb + 1 : rb;
  const size_t cz = static_cast<size_t>(c) * p.Z + z;
  const int32_t* dz = db + cz * kLimbs * CW * M;
  const uint32_t* qz = query + cz * p.DIM0 * R;

  const int nbg = (NPR + bs - 1) / bs;
  const int bg0 = blockIdx.x * p.gpb;
  const int ngl = min(p.gpb, nbg - bg0);       // bin groups of this block
  const int MT = (IT + 15) / 16;
  const int nks = (CW + SW - 1) / SW;
  const int S = ngl * MT * nks;
  const int rbw = min(rb, R - col0);           // live columns of the block
  const int ntb = (rbw + 7) / 8;               // live 8-column tiles

  // The DB words of step s: 64 sw rows (limb, step word, tile row) of bs
  // bins, copied 16 bytes (4 bins) or 4 bytes a copy, copy id tid + 256 n.
  // Then the bs bins' idx_j of the step's 32 slots (idx 0 past cap and
  // num_per), 16 bytes a copy. Words past cap, IT or num_per are not
  // copied: whatever the stage holds there meets zero B words (slots past
  // cap) or is never stored.
  const int tid = threadIdx.x;
  auto load_stage = [&](int s, uint32_t* buf) {
    const int ks = s % nks, mt = (s / nks) % MT, bgl = s / (nks * MT);
    const int gb = (bg0 + bgl) * bs;             // first bin of the group
    auto copy = [&](int r, int b, bool wide) {
      const int i = r % 16, cwl = (r / 16) % SW, k = r / (16 * SW);
      const int row = mt * 16 + i, cw = ks * SW + cwl, bin = gb + b;
      if (bin < NPR && row < IT && cw < CW) {
        const int32_t* src = dz + (static_cast<size_t>(k) * CW + cw) * M +
                             static_cast<size_t>(row) * NPR + bin;
        uint32_t* dst = buf + sh::at(k, cwl, i, b);
        if (wide)
          cp_async16(dst, src);
        else
          cp_async4(dst, src);
      }
    };
    if (p.vec) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int id = tid + kThreads * n;
        copy(id >> (lbs - 2), 4 * (id & ((bs >> 2) - 1)), true);
      }
    } else {
#pragma unroll 4
      for (int n = 0; n < 16; ++n) {
        const int id = tid + kThreads * n;
        copy(id >> lbs, id & (bs - 1), false);
      }
    }
    for (int id = tid; id < 8 * bs; id += kThreads) {
      const int ib = gb + id / 8, slot = ks * 32 + 4 * (id % 8);
      uint32_t* dst = buf + kDbWords + 4 * id;
      if (ib < NPR && slot < cap)
        cp_async16(dst, idx_j + static_cast<size_t>(ib) * cap + slot);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  };

  for (int s = 0; s < p.ns - 1; ++s) {
    if (s < S) load_stage(s, stage + s * stw);
    cp_async_commit();
  }

  if (tid < kEpi) wts[tid] = p.w[c][tid];
  // the query limbs, 8 ntw loads of a thread in flight at once (a block's
  // 16 K words at R = 32 in two rounds)
  constexpr int kPack = 8 * NTW;
  const int items = p.DIM0 * rb;
  for (int base = tid; base < items; base += kPack * kThreads) {
    uint32_t v[kPack];
#pragma unroll
    for (int u = 0; u < kPack; ++u) {
      const int idx = base + u * kThreads;
      const int j = idx / rb, col = idx % rb;
      v[u] = idx < items && col0 + col < R ? qz[j * R + col0 + col] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kPack; ++u) {
      const int idx = base + u * kThreads;
      if (idx < items) {
        uint32_t word = 0;
#pragma unroll
        for (int l = 0; l < kLimbs; ++l)
          word |= scan_common::limb(v[u], l) << (8 * l);
        W[(idx / rb) * ld + idx % rb] = word;
      }
    }
  }

  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  int32_t acc[kWeights][NTW][4];
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][u][e] = 0;

  for (int s = 0, cur = 0; s < S; ++s, cur = cur + 1 == p.ns ? 0 : cur + 1) {
    cp_async_wait(p.ns);
    // stage s has landed for every thread, and every warp is done with the
    // stage of step s - 1, which the copies of step s + ns - 1 refill
    __syncthreads();
    if (s + p.ns - 1 < S)
      load_stage(s + p.ns - 1, stage + (cur == 0 ? p.ns - 1 : cur - 1) * stw);
    cp_async_commit();

    const int ks = s % nks, mt = (s / nks) % MT, bgl = s / (nks * MT);
    const uint32_t* buf = stage + cur * stw;
#pragma unroll
    for (int x = 0; x < bs / 8; ++x) {  // one bin at SW 8
      const int bl = warp + 8 * x;
      const int bin = (bg0 + bgl) * bs + bl;
      if (bin >= NPR) continue;  // warp-uniform
      uint32_t a[kLimbs][4];
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) {
        // words past sw (sw < 8: slots past cap) are zero
        const bool lo = t < SW, hi = t + 4 < SW;
        a[k][0] = lo ? buf[sh::at(k, t, g, bl)] : 0u;
        a[k][1] = lo ? buf[sh::at(k, t, g + 8, bl)] : 0u;
        a[k][2] = hi ? buf[sh::at(k, t + 4, g, bl)] : 0u;
        a[k][3] = hi ? buf[sh::at(k, t + 4, g + 8, bl)] : 0u;
      }
      // the query rows of this lane's slots: 32 ks + 4t + e and 16 further
      const int4* js = reinterpret_cast<const int4*>(buf + kDbWords) +
                       bl * 8 + t;
      const int4 jr[2] = {js[0], js[4]};
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        if (u < ntb) {  // warp-uniform
          const int col = u * 8 + g;
          uint32_t b[2][kLimbs];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (col < rb && ks * 32 + 16 * h + 4 * t < cap) {
              transpose4(W[jr[h].x * ld + col], W[jr[h].y * ld + col],
                         W[jr[h].z * ld + col], W[jr[h].w * ld + col], b[h]);
            } else {
#pragma unroll
              for (int l = 0; l < kLimbs; ++l) b[h][l] = 0;
            }
          }
#pragma unroll
          for (int k = 0; k < kLimbs; ++k)
#pragma unroll
            for (int l = 0; l < kLimbs; ++l)
              mma_s8(acc[k + l][u], a[k], b[0][l], b[1][l]);
        }
      }

      if (ks == nks - 1) {
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int col = u * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = mt * 16 + g + 8 * h;
            if (col < rbw && i < IT) {
              int32_t v0[kWeights], v1[kWeights];
#pragma unroll
              for (int w = 0; w < kWeights; ++w) {
                v0[w] = acc[w][u][2 * h];
                v1[w] = acc[w][u][2 * h + 1];
              }
              const uint2 o = make_uint2(recombine(v0, wts, q),
                                         recombine(v1, wts, q));
              *reinterpret_cast<uint2*>(
                  out + (cz * M + static_cast<size_t>(i) * NPR + bin) * R +
                  col0 + col) = o;
            }
          }
        }
#pragma unroll
        for (int w = 0; w < kWeights; ++w)
#pragma unroll
          for (int u = 0; u < NTW; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[w][u][e] = 0;
      }
    }
  }
}

template <int NTW, int SW>
int launch(const int32_t* db, const int32_t* idx_j, const uint32_t* query,
           uint32_t* out, const Tiling& p, int nbb, cudaStream_t st) {
  const int ld = p.rb >= 8 ? p.rb + 1 : p.rb;
  const size_t smem = sizeof(uint32_t) *
                      (static_cast<size_t>(p.ns) * Shape<SW>::kWords + 16 +
                       static_cast<size_t>(p.DIM0) * ld);
  cudaError_t err = cudaFuncSetAttribute(
      scan_compact_kernel<NTW, SW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nbb, p.Z, 2 * p.ncb);
  scan_compact_kernel<NTW, SW><<<grid, kThreads, smem, st>>>(db, idx_j, query,
                                                             out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NTW>
int launch_sw(const int32_t* db, const int32_t* idx_j, const uint32_t* query,
              uint32_t* out, const Tiling& p, int nbb, int sw,
              cudaStream_t st) {
  switch (sw) {
    case 2: return launch<NTW, 2>(db, idx_j, query, out, p, nbb, st);
    case 4: return launch<NTW, 4>(db, idx_j, query, out, p, nbb, st);
    case 8: return launch<NTW, 8>(db, idx_j, query, out, p, nbb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// db: (2, Z, 4, CW, M) int32 words of int8 limbs; idx_j: (NPR, 4*CW) int32
// (16-byte aligned) with M a multiple of NPR; query: (2, Z, DIM0, R) uint32
// residues; out: (2, Z, M, R) uint32, R even. A block takes rb columns
// (even, at most 8 * ntw; ncb blocks cover R) and gpb groups of 64 / sw
// bins (nbb blocks cover num_per), ns stages deep, sw slot words a step (8,
// or 4 or 2 where CW is at most that); ntw is 1, 2 or 4; vec 1 copies the
// DB words 16 bytes at a time (db 16-byte aligned, NPR % 4 == 0). weights:
// host uint32 [2][10], per channel 2^{7s} mod q_c for s < 7, then c =
// 2^32 mod q_c, floor(2^32 c / q_c) and floor(2^32 / q_c).
extern "C" int sdk_scan_compact(const void* db, const void* idx_j,
                                const void* query, void* out, int Z, int M,
                                int NPR, int CW, int DIM0, int R, int ntw,
                                int rb, int ncb, int gpb, int nbb, int ns,
                                int vec, int sw, unsigned int q0,
                                unsigned int q1,
                                const void* weights, void* stream) {
  const auto* d = static_cast<const int32_t*>(db);
  const auto* ij = static_cast<const int32_t*>(idx_j);
  const auto* qr = static_cast<const uint32_t*>(query);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (rb < 2 || rb % 2 || rb > 8 * ntw || R % 2 || M % NPR || gpb < 1 ||
      ns < 2 || ns > 4 || (vec && NPR % 4) ||
      !(sw == 8 || ((sw == 4 || sw == 2) && CW <= sw)) ||
      reinterpret_cast<uintptr_t>(idx_j) % 16 ||
      (vec && reinterpret_cast<uintptr_t>(db) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Tiling p{Z, M, NPR, CW, DIM0, R, rb, ncb, gpb, ns, vec, {q0, q1}, {}};
  const auto* wq = static_cast<const uint32_t*>(weights);
  for (int c = 0; c < 2; ++c)
    for (int s = 0; s < kEpi; ++s) p.w[c][s] = wq[c * kEpi + s];
  switch (ntw) {
    case 1: return launch_sw<1>(d, ij, qr, o, p, nbb, sw, st);
    case 2: return launch_sw<2>(d, ij, qr, o, p, nbb, sw, st);
    case 4: return launch_sw<4>(d, ij, qr, o, p, nbb, sw, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
