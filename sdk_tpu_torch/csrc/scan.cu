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
// split into four 7-bit limbs in shared memory. The product of DB limb k and
// query limb l is summed by weight s = k + l in int32 on the int8 tensor
// cores (mma.sync m16n8k32, s8 x s8 -> s32) and recombined mod q by the
// epilogue shared with the compact scan (scan_common.cuh). The int32
// partials live in registers only: they never reach device memory.
//
// DB layout (the port's single dense layout), as int32 words:
//   (crt, Z, L=4, JW=dim0/4, M)   with M = instances * trials * num_per
// where one word holds limb k of the four neighbouring columns j = 4jw..4jw+3
// (byte b = column 4jw+b). Total bytes equal the JAX engine's
// index_hbm_bytes (server_jax.py:107).
//
// Why that layout feeds mma.sync as it is (PTX fragment layouts of
// m16n8k32 .s8; lane = 4g + t): A is 16 rows m x 32 columns j, row-major,
// and register a0 of lane (g, t) holds row g, columns 4t..4t+3, which is
// exactly the DB word (jw0 + t, m0 + g); a1 is (jw0 + t, m0 + g + 8), a2
// (jw0 + 4 + t, m0 + g), a3 (jw0 + 4 + t, m0 + g + 8). Each A register is one
// coalesced 4-byte load: a warp instruction reads 4 jw rows x 8 neighbouring
// m, four whole 32-byte sectors. B (32 j x 8 columns r) register b0 of lane
// (g, t) is the packed query word (jw0 + t, column g), b1 that of jw0 + 4 + t.
// The accumulator's c0, c1 are row g, columns 2t, 2t + 1; c2, c3 row g + 8.
//
// What bounds it on the H100. The 1 GiB bucket's index is 8.59 GB, read once
// per scan: 2.56 ms at 3.35 TB/s. Each k32 step of a warp runs 16 MMAs
// (4 DB limbs x 4 query limbs) per 8-column tile, so R = 32 columns (a
// 16-query batch) are 2.2 T int8 operations, about 1.1 ms at the tensor
// cores' peak: bytes bound it at every batch size, where the former __dp4a
// loop was bound by the integer pipes and its shared-memory reads. R = 2 (one
// read) is padded to one 8-column tile: 4x the products it needs, still far
// under the tensor cores' rate. Measured on an H100 80GB HBM3 at 700 W
// (tools/scan_bench_gpu.py, PERF.md): R = 2 reads the index at ~90% of the
// byte bound; at R = 32 each further 8-column tile adds 0.35-0.7 ms at the
// same bytes, so the MMAs are not hidden behind the loads (51-54%).
//
// Design: a block owns one (channel, z), a range of 8-column tiles and
// wm x mtw m16 tiles. Its prologue packs the query limbs of its columns into
// shared memory in fragment order, [k32 step][tile][limbs 0-1 | 2-3][lane]
// as uint4, so a lane reads its B fragments of all four limbs with two
// conflict-free 16-byte loads, zero past R and past JW. Warp (cg, wm) owns
// ntw tiles of the block and one m16 tile at a time; the DB words of the
// next two k32 steps are loaded (predicated to zero past JW and M) while the
// MMAs of the current ones run, also across the step from one m16 tile to
// the next. No wgmma, TMA or cp.async ring yet.
//
// Two forms. scan_kernel, for narrow batches, streams 1-4 tiles a warp
// with up to two blocks an SM; where the query limbs of its columns over
// all of JW do not fit in shared memory, it refills them in chunks of kc
// steps for every m16 tile. Above 64 columns at the 1 GiB bucket's JW = 128
// that refill is the cost: at R = 128 a block holds 8 of the 16 steps, so
// each of its 64 m16 tiles packs the query twice (strided loads and limb
// splits by 4 warps between two barriers), ~70 GB of query loads and ~4 G
// packed items a scan. scan_resident_kernel holds the query limbs of its
// columns over all of JW in shared memory, packed once a block (128 KB at
// 64 columns and JW = 128), and its 8 warps walk every m16 tile of its
// rows against them. The R columns split into blocks of 64 (or 32); the
// blocks of one (channel, z) and range of rows are neighbours in the grid,
// so they run side by side and share the index words through L2 (a thread
// block cluster around them measured no faster). Its epilogue reduces with
// host constants (scan_common::recombine) where scan_kernel divides in 64
// bits (recombine_store), which cost a third of the resident form's time.
// On an H100 80GB HBM3 at 700 W, the whole index at R = 128: 183.8 ms in
// scan_kernel, 13.0 ms in scan_resident_kernel (tools/scan_bench_gpu.py).
//
#include <cstdint>
#include <cuda_runtime.h>

#include "scan_common.cuh"

namespace {

using scan_common::kEpi;
using scan_common::kLimbs;
using scan_common::kWeights;

constexpr int kStepWords = 8;   // jw words of one k32 step (32 columns j)
constexpr int kSteps = 2;       // k32 steps of an iteration
constexpr int kMaxThreads = 256;
constexpr int kResNtw = 4;      // tiles of a warp in the resident form

struct Tiling {
  int Z, M, JW, R;
  int ntp;   // 8-column tiles of a block (cgb column groups x ntw)
  int wm;    // warps of a column group, along m
  int mtw;   // m16 tiles of a warp, one after another
  int kc;    // k32 steps of query fragments in shared memory
  uint32_t q0, q1;
};

// d += A (16 x 32, row-major) x B (32 x 8, column-major), int8 -> int32.
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pack the query limbs of k32 steps ks0 .. ks0 + count - 1 and the block's
// ntp tiles from column col0 into qf, in fragment order; zero past JW and R.
__device__ void fill_query(uint4* qf, const uint32_t* __restrict__ qz, int ks0,
                           int count, int ntp, int col0, int JW, int R) {
  uint32_t* w = reinterpret_cast<uint32_t*>(qf);
  const int items = count * ntp * 64;  // (step, tile, h, t, g)
#pragma unroll 4
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int g = idx % 8;
    const int t = (idx / 8) % 4;
    const int h = (idx / 32) % 2;
    const int tile = (idx / 64) % ntp;
    const int ks = idx / (64 * ntp);
    const int jw = (ks0 + ks) * kStepWords + 4 * h + t;
    const int col = col0 + tile * 8 + g;
    uint32_t v[4] = {0, 0, 0, 0};
    if (jw < JW && col < R) {
#pragma unroll
      for (int b = 0; b < 4; ++b) v[b] = qz[(4 * jw + b) * R + col];
    }
    // word (limb l, h) of lane 4g + t: uint4 ((ks, tile), l / 2), component
    // 2 (l % 2) + h
    uint32_t* f = w + ((ks * ntp + tile) * 64 + 4 * g + t) * 4;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= scan_common::limb(v[b], l) << (8 * b);
      f[(l / 2) * 128 + 2 * (l % 2) + h] = word;
    }
  }
}

template <int NTW>
__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const int32_t* __restrict__ db, const uint32_t* __restrict__ query,
            uint32_t* __restrict__ out, const Tiling p) {
  extern __shared__ uint4 qf[];  // [kc][ntp][2][32]
  const int ncb = gridDim.z / 2;
  const int c = blockIdx.z / ncb;
  const int col0 = (blockIdx.z % ncb) * p.ntp * 8;
  const int z = blockIdx.y;
  const uint32_t q = c ? p.q1 : p.q0;
  const int JW = p.JW, M = p.M, R = p.R;
  const size_t cz = static_cast<size_t>(c) * p.Z + z;
  const uint32_t* qz = query + cz * 4 * JW * R;
  const int32_t* dz = db + cz * kLimbs * JW * M;
  const int plane = JW * M;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % p.wm;
  const int u0 = (warp / p.wm) * NTW;  // the warp's first tile in the block
  const int nks = (JW + kStepWords - 1) / kStepWords;
  const int nit = (nks + kSteps - 1) / kSteps;  // iterations of an m16 tile
  const int chunk = p.kc / kSteps;              // iterations a fill covers
  const bool one_fill = nit <= chunk;

  // the first row (fragment row g) of the warp's i-th m16 tile; M (no row)
  // past the warp's last tile
  auto row_of = [&](int i) {
    return i < p.mtw ? ((blockIdx.x * p.mtw + i) * p.wm + wm) * 16 + g : M;
  };
  // the A fragments of the k32 steps of iteration it, rows m and m + 8
  auto load_a = [&](uint32_t (&a)[kSteps][kLimbs][4], int it, int m) {
    const bool r0 = m < M, r1 = m + 8 < M;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int j0 = (it * kSteps + s) * kStepWords + t, j1 = j0 + 4;
      const bool c0 = j0 < JW, c1 = j1 < JW;
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) {
        const int32_t* d = dz + k * plane + m;
        a[s][k][0] = (c0 && r0) ? d[j0 * M] : 0;
        a[s][k][1] = (c0 && r1) ? d[j0 * M + 8] : 0;
        a[s][k][2] = (c1 && r0) ? d[j1 * M] : 0;
        a[s][k][3] = (c1 && r1) ? d[j1 * M + 8] : 0;
      }
    }
  };

  int32_t acc[kWeights][NTW][4];
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][u][e] = 0;

  uint32_t a[kSteps][kLimbs][4];
  load_a(a, 0, row_of(0));
  if (one_fill) {
    fill_query(qf, qz, 0, nit * kSteps, p.ntp, col0, JW, R);
    __syncthreads();
  }

  int i = 0, it = 0, itl = 0;  // m16 tile, iteration, iteration of the fill
  const int steps = p.mtw * nit;
  for (int step = 0; step < steps; ++step) {
    if (!one_fill && itl == 0) {
      __syncthreads();
      fill_query(qf, qz, it * kSteps, min(p.kc, (nit - it) * kSteps), p.ntp,
                 col0, JW, R);
      __syncthreads();
    }
    int i2 = i, it2 = it + 1;
    if (it2 == nit) {
      it2 = 0;
      ++i2;
    }
    uint32_t an[kSteps][kLimbs][4];
    load_a(an, it2, row_of(i2));

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        const uint4* f = qf + ((itl * kSteps + s) * p.ntp + u0 + u) * 64 + lane;
        const uint4 lo = f[0], hi = f[32];
        const uint32_t b[kLimbs][2] = {
            {lo.x, lo.y}, {lo.z, lo.w}, {hi.x, hi.y}, {hi.z, hi.w}};
#pragma unroll
        for (int k = 0; k < kLimbs; ++k)
#pragma unroll
          for (int l = 0; l < kLimbs; ++l)
            mma_s8(acc[k + l][u], a[s][k], b[l][0], b[l][1]);
      }
    }

    if (it == nit - 1) {
      const int m = row_of(i);
#pragma unroll
      for (int u = 0; u < NTW; ++u) {
        const int col = col0 + (u0 + u) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m + 8 * h;
          if (col < R && row < M) {
            int32_t part[kWeights][2];
#pragma unroll
            for (int s = 0; s < kWeights; ++s) {
              part[s][0] = acc[s][u][2 * h];
              part[s][1] = acc[s][u][2 * h + 1];
            }
            scan_common::recombine_store<2>(
                part, q, out + (cz * M + row) * R + col);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kWeights; ++s)
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][u][e] = 0;
    }

#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int k = 0; k < kLimbs; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[s][k][e] = an[s][k][e];
    itl = (it2 == 0 || itl + 1 == chunk) ? 0 : itl + 1;
    i = i2;
    it = it2;
  }
}

// The epilogue constants of both channels (scan_common::kEpi each).
struct Epilogue {
  uint32_t w[2][kEpi];
};

// The resident form: scan_kernel's walk at ntw = 4 with the query limbs of
// all of JW (p.kc steps) packed once, before it. The grid is (ncb * bx, Z,
// 2), block x = bx index * ncb + column block, so neighbouring blocks share
// their (channel, z) and rows. A warp without columns, or past the last
// m16 tile, packs and then stops. The epilogue reduces with the channel's
// constants (scan_common::recombine), kept in shared memory after the
// query fragments.
__global__ void __launch_bounds__(kMaxThreads)
scan_resident_kernel(const int32_t* __restrict__ db,
                     const uint32_t* __restrict__ query,
                     uint32_t* __restrict__ out, const Tiling p, int ncb,
                     const Epilogue e) {
  extern __shared__ uint4 qf[];  // [kc][ntp][2][32], then kEpi words
  const int cb = blockIdx.x % ncb, bxi = blockIdx.x / ncb;
  const int c = blockIdx.z;
  const int col0 = cb * p.ntp * 8;
  const uint32_t q = c ? p.q1 : p.q0;
  const int JW = p.JW, M = p.M, R = p.R;
  const size_t cz = static_cast<size_t>(c) * p.Z + blockIdx.y;
  const uint32_t* qz = query + cz * 4 * JW * R;
  const int32_t* dz = db + cz * kLimbs * JW * M;
  uint32_t* oz = out + cz * M * R;
  const int plane = JW * M;
  uint32_t* wts = reinterpret_cast<uint32_t*>(qf + p.kc * p.ntp * 64);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % p.wm;
  const int u0 = (warp / p.wm) * kResNtw;  // the warp's first tile
  const int nit = p.kc / kSteps;             // iterations of an m16 tile
  // the warp's m16 tiles that hold rows: (bxi * mtw + i) * wm + wm below
  // ceil(M / 16); none without columns
  const int mt = (M + 15) / 16;
  int mine = (mt - wm + p.wm - 1) / p.wm - bxi * p.mtw;
  mine = col0 + u0 * 8 < R ? max(0, min(p.mtw, mine)) : 0;
  const int row0 = (bxi * p.mtw * p.wm + wm) * 16 + g;

  auto row_of = [&](int i) { return i < mine ? row0 + i * p.wm * 16 : M; };
  // the A fragments of the k32 steps of iteration it, rows m and m + 8
  auto load_a = [&](uint32_t (&a)[kSteps][kLimbs][4], int it, int m) {
    const bool r0 = m < M, r1 = m + 8 < M;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int j0 = (it * kSteps + s) * kStepWords + t, j1 = j0 + 4;
      const bool c0 = j0 < JW, c1 = j1 < JW;
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) {
        const int32_t* d = dz + k * plane + m;
        a[s][k][0] = (c0 && r0) ? d[j0 * M] : 0;
        a[s][k][1] = (c0 && r1) ? d[j0 * M + 8] : 0;
        a[s][k][2] = (c1 && r0) ? d[j1 * M] : 0;
        a[s][k][3] = (c1 && r1) ? d[j1 * M + 8] : 0;
      }
    }
  };

  int32_t acc[kWeights][kResNtw][4];
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
#pragma unroll
    for (int u = 0; u < kResNtw; ++u)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) acc[s][u][e4] = 0;

  uint32_t a[kSteps][kLimbs][4];
  load_a(a, 0, row_of(0));
  if (threadIdx.x < kEpi) wts[threadIdx.x] = e.w[c][threadIdx.x];
  fill_query(qf, qz, 0, p.kc, p.ntp, col0, JW, R);
  __syncthreads();

  int i = 0, it = 0;  // m16 tile, iteration
  const int steps = mine * nit;
  for (int step = 0; step < steps; ++step) {
    int i2 = i, it2 = it + 1;
    if (it2 == nit) {
      it2 = 0;
      ++i2;
    }
    uint32_t an[kSteps][kLimbs][4];
    load_a(an, it2, row_of(i2));

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int u = 0; u < kResNtw; ++u) {
        const uint4* f = qf + ((it * kSteps + s) * p.ntp + u0 + u) * 64 + lane;
        const uint4 lo = f[0], hi = f[32];
        const uint32_t b[kLimbs][2] = {
            {lo.x, lo.y}, {lo.z, lo.w}, {hi.x, hi.y}, {hi.z, hi.w}};
#pragma unroll
        for (int k = 0; k < kLimbs; ++k)
#pragma unroll
          for (int l = 0; l < kLimbs; ++l)
            mma_s8(acc[k + l][u], a[s][k], b[l][0], b[l][1]);
      }
    }

    if (it == nit - 1) {
      const int m = row_of(i);
#pragma unroll
      for (int u = 0; u < kResNtw; ++u) {
        const int col = col0 + (u0 + u) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m + 8 * h;
          if (col < R && row < M) {
            int32_t v0[kWeights], v1[kWeights];
#pragma unroll
            for (int s = 0; s < kWeights; ++s) {
              v0[s] = acc[s][u][2 * h];
              v1[s] = acc[s][u][2 * h + 1];
            }
            *reinterpret_cast<uint2*>(oz + static_cast<size_t>(row) * R +
                                      col) =
                make_uint2(scan_common::recombine(v0, wts, q),
                           scan_common::recombine(v1, wts, q));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kWeights; ++s)
#pragma unroll
        for (int u = 0; u < kResNtw; ++u)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) acc[s][u][e4] = 0;
    }

#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int k = 0; k < kLimbs; ++k)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) a[s][k][e4] = an[s][k][e4];
    i = i2;
    it = it2;
  }
}

template <int NTW>
int launch(const int32_t* db, const uint32_t* query, uint32_t* out,
           const Tiling& p, int ncb, int cgb, int bx, cudaStream_t st) {
  const size_t smem = sizeof(uint4) * 64 * p.kc * p.ntp;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bx, p.Z, 2 * ncb);
  scan_kernel<NTW><<<grid, 32 * p.wm * cgb, smem, st>>>(db, query, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// db: (2, Z, 4, JW, M) int32 words of int8 limbs; query: (2, Z, 4*JW, R)
// uint32 residues; out: (2, Z, M, R) uint32. A block takes cgb column groups
// of ntw (1, 2 or 4) 8-column tiles and wm x mtw m16 tiles, with kc (a
// multiple of 2, the k32 steps of an iteration) k32 steps of query limbs in
// shared memory; the grid is (bx, Z, 2 * ncb), ncb * cgb * ntw * 8
// >= R, bx * wm * mtw * 16 >= M, 32 * wm * cgb <= 256 threads.
extern "C" int sdk_scan(const void* db, const void* query, void* out, int Z,
                        int M, int JW, int R, int ntw, int ncb, int cgb,
                        int wm, int mtw, int bx, int kc,
                        unsigned int q0, unsigned int q1, void* stream) {
  const auto* d = static_cast<const int32_t*>(db);
  const auto* qr = static_cast<const uint32_t*>(query);
  auto* o = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (32 * wm * cgb > kMaxThreads || kc % kSteps) return cudaErrorInvalidValue;
  const Tiling p{Z, M, JW, R, cgb * ntw, wm, mtw, kc, q0, q1};
  switch (ntw) {
    case 1: return launch<1>(d, qr, o, p, ncb, cgb, bx, st);
    case 2: return launch<2>(d, qr, o, p, ncb, cgb, bx, st);
    case 4: return launch<4>(d, qr, o, p, ncb, cgb, bx, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The resident form, same arrays: a block takes cgb column groups of 4
// 8-column tiles, with their query limbs of all of JW in shared memory,
// and wm x mtw m16 tiles; the grid is (ncb * bx, Z, 2), ncb * cgb * 32 >=
// R, bx * wm * mtw * 16 >= M, 32 * wm * cgb <= 256 threads. weights: host
// uint32 [2][kEpi], per channel 2^{7s} mod q_c for s < 7, then c = 2^32
// mod q_c, floor(2^32 c / q_c) and floor(2^32 / q_c).
extern "C" int sdk_scan_resident(const void* db, const void* query,
                                 void* out, int Z, int M, int JW, int R,
                                 int ncb, int cgb, int wm, int mtw, int bx,
                                 unsigned int q0, unsigned int q1,
                                 const void* weights, void* stream) {
  if (32 * wm * cgb > kMaxThreads) return cudaErrorInvalidValue;
  const int nks = (JW + kStepWords - 1) / kStepWords;
  const int kc = (nks + kSteps - 1) / kSteps * kSteps;
  const Tiling p{Z, M, JW, R, cgb * kResNtw, wm, mtw, kc, q0, q1};
  Epilogue e;
  const auto* wq = static_cast<const uint32_t*>(weights);
  for (int c = 0; c < 2; ++c)
    for (int s = 0; s < kEpi; ++s) e.w[c][s] = wq[c * kEpi + s];
  const size_t smem = sizeof(uint4) * 64 * kc * p.ntp + sizeof(e.w[0]);
  cudaError_t err = cudaFuncSetAttribute(
      scan_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ncb * bx, Z, 2);
  scan_resident_kernel<<<grid, 32 * wm * cgb, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(db), static_cast<const uint32_t*>(query),
      static_cast<uint32_t*>(out), p, ncb, e);
  return static_cast<int>(cudaGetLastError());
}
