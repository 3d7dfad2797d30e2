// Item ingest (kernel H), fused: chunk bytes -> mod-p coefficients -> NTT
// residues -> 7-bit limbs written in place into the resident index.
//
// Replaces sdk_tpu/kv/ingest.py:61 ingest_items_device and the scatter of
// DbUpdateBuffer.flush (sdk_tpu/kv/ingest.py:196-339: db_limbs_host + the
// donated .at[].set programs). The composed form made, per 1024 items of the
// 1 GiB bucket, 268 MB of int64 words, 134 MB of int32 residues and 268 MB of
// limbs on their way to an index_put; here only a scratch of residues for
// INGEST_BATCH_ITEMS items (kv/ingest.py) exists.
//
// What bounds it on the H100: the stores into the index. An item owns one
// byte in each of 2 * z * 4 * chunks places of the index [c, z, l, col/4,
// it, bin, col%4], each z-stride (2 MB in the dense 1 GiB index) from the
// next. Stored a byte at a time, by one block an item, every store touches
// its own 32-byte sector and device memory sees a read-modify-write of a
// sector for each byte (the former form ran at 55x its byte bound). A
// sector holds the bytes of 8 neighbouring bins x 4 neighbouring columns of
// one (c, z, l, col/4, it): so the items are grouped by sector on the host
// (kv/ingest.py:sector_plan; a bulk load, sorted by item index, fills whole
// groups), and each sector is written whole, once, by the one block that
// owns its group, with 16-byte stores. Two kernels a batch of groups, both
// launched by the one entry point:
//
//   (a) transform_kernel: one polynomial (item, chunk, channel) a 128-thread
//       block on the transform core (ntt_device.cuh, sdk::core). Each thread
//       extracts 16 logp-bit fields from the chunk's little-endian bit
//       stream (a 4-byte window read byte by byte, zero past the chunk's
//       end; where logp = 8 and the chunk is a whole number of 4-byte words,
//       four coefficients are one 4-byte load),
//       recentres them (w > p/2 -> w - p, into [0, q_c)), stages them
//       through shared memory into the core's first layout, transforms (two
//       group barriers) and stores the canonical residues with 16-byte
//       stores: into the caller's output (K, chunks, 2, z), which is what
//       ingest_items_device returns, or into the batch's scratch, rows in
//       the plan's order.
//   (b) sector_kernel: one (channel c, tile of 128 z, group, chunk it) a
//       block, the chunk fastest. It gathers the members' residue rows
//       (coalesced) into shared memory, and each thread then takes one
//       sector-half (16 members of one z), splits its residues into the four
//       7-bit limbs and stores 16 bytes a limb. Lanes 2i and 2i + 1 of a warp
//       hold the two halves of one sector, so a store instruction writes 16
//       whole sectors. A partial group (a member's (bin, column) holds no
//       item of this launch) first loads its four sectors and keeps the
//       bytes of the absent members. No two blocks write one sector: no
//       atomics and no race.
//
// The scratch of a batch is INGEST_BATCH_ITEMS rows of (chunks, 2, z) u32,
// small enough that (b) finds most of what (a) wrote still in L2.
// Indexes with fewer than 8 bins a row (the small test configurations) have
// sectors of 4 * num_per bytes, written by one thread each (kW below).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

using namespace sdk::core;

constexpr int kZTile = 128;                 // z a sector_kernel block
constexpr int kZTiles = kN / kZTile;

template <bool kBytes>   // logp == 8, chunk_bytes % 4 == 0: four a word
__global__ void __launch_bounds__(kGroup, 8)
transform_kernel(const uint8_t* __restrict__ bytes,
                 const long long* __restrict__ order, long long p0,
                 const uint32_t* __restrict__ tables,
                 uint32_t* __restrict__ res, int chunks, int chunk_bytes,
                 int n_coeffs, int logp, uint32_t q0, uint32_t q1) {
  __shared__ __align__(16) uint32_t buf_a[kPad];
  __shared__ __align__(16) uint32_t buf_b[kPad];
  const int j = threadIdx.x;
  const long long poly = blockIdx.x;          // (row, it, c), c fastest
  const int c = static_cast<int>(poly & 1);
  const long long r = (poly >> 1) / chunks;
  const int it = static_cast<int>((poly >> 1) - r * chunks);
  const long long k = order != nullptr ? order[p0 + r] : r;
  const uint8_t* src = bytes + (k * chunks + it) * chunk_bytes;
  const uint32_t q = c ? q1 : q0;
  const uint32_t p = 1u << logp;
  // coefficients 4j + 512 rr + e, staged to La through buf_b (as ntt.cu)
  const int sb = pad(4 * j);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    uint32_t four = 0;      // kBytes: bytes 4j + 512 rr .. + 3, one load
    if constexpr (kBytes) {
      const int b0 = 4 * j + 512 * rr;
      // every chunk starts on a word: the launch checks chunk_bytes % 4
      if (b0 < chunk_bytes) four = reinterpret_cast<const uint32_t*>(src)[b0 >> 2];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + 512 * rr + e;
      uint32_t w = 0;
      if (x < n_coeffs) {
        if constexpr (kBytes) {
          w = (four >> (8 * e)) & 255u;
        } else {
          const int bit = logp * x;
          const int b0 = bit >> 3;
          uint32_t win = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t byte = b0 + b < chunk_bytes ? src[b0 + b] : 0u;
            win |= byte << (8 * b);
          }
          w = (win >> (bit & 7)) & (p - 1);
        }
      }
      // recentre: w > p/2 stands for w - p
      buf_b[sb + pad(512 * rr + e)] = w > p / 2 ? q - (p - w) : w;
    }
  }
  __syncthreads();
  uint32_t v[kPer];
  from_smem<0>(buf_b, j, v);
  forward(v, buf_a, buf_b, j, 0, tables + static_cast<size_t>(c) * 4 * kN, q);
  uint32_t* y = res + poly * kN + lc_base(j);
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    reinterpret_cast<uint4*>(y)[h] = make_uint4(
        sdk::ntt_canonical(v[4 * h], q), sdk::ntt_canonical(v[4 * h + 1], q),
        sdk::ntt_canonical(v[4 * h + 2], q),
        sdk::ntt_canonical(v[4 * h + 3], q));
  }
}

// Limb l of four residues as the four bytes of a word.
__device__ __forceinline__ uint32_t limb_word(const uint32_t* v, int l) {
  const int s = 7 * l;
  return ((v[0] >> s) & 127u) | (((v[1] >> s) & 127u) << 8) |
         (((v[2] >> s) & 127u) << 16) | (((v[3] >> s) & 127u) << 24);
}

// Bits 0-3 of `bits` -> a byte mask of a word.
__device__ __forceinline__ uint32_t byte_mask(uint32_t bits) {
  return (bits & 1u ? 0xFFu : 0u) | (bits & 2u ? 0xFF00u : 0u) |
         (bits & 4u ? 0xFF0000u : 0u) | (bits & 8u ? 0xFF000000u : 0u);
}

// M: bytes of a sector (4 columns x min(8, num_per) bins) = its members.
// A thread stores kW of them; kParts threads share a sector, neighbouring
// lanes. The grid runs the chunk fastest, then the group: blocks resident
// together write the 16 chunks' sectors of one (c, z, l) of an item, 256
// bytes apart, and the neighbouring bin octets of a bulk load, 32 bytes
// apart, so that device memory sees neighbouring sectors together.
template <int M>
__global__ void __launch_bounds__(kZTile * (M > 16 ? M / 16 : 1))
sector_kernel(const uint32_t* __restrict__ res, const int* __restrict__ table,
              const long long* __restrict__ groups, long long p0,
              int8_t* __restrict__ db, long long groups_n, int chunks,
              long long row_bytes, long long it_bytes) {
  constexpr int kW = M < 16 ? M : 16;
  constexpr int kParts = M / kW;
  constexpr int kWarps = kZTile * kParts / 32;
  __shared__ int pos[M];
  // row stride kZTile + 1: the halves' reads (members 16h + i at z) fall on
  // 32 distinct banks
  __shared__ uint32_t stage[M][kZTile + 1];
  const long long git = blockIdx.x / chunks;       // ((c, zt), g), it
  const int it = static_cast<int>(blockIdx.x - git * chunks);
  const long long czt = git / groups_n;
  const long long g = git - czt * groups_n;
  const int c = static_cast<int>(czt / kZTiles);
  const int zt = static_cast<int>(czt % kZTiles);
  if (threadIdx.x < M) pos[threadIdx.x] = table[g * M + threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < M; m += kWarps) {
    const int p = pos[m];
    if (p < 0) continue;
    const uint32_t* src =
        res + (((p - p0) * chunks + it) * 2 + c) * kN + zt * kZTile;
#pragma unroll
    for (int w = lane; w < kZTile; w += 32) stage[m][w] = src[w];
  }
  __syncthreads();
  const int part = threadIdx.x % kParts;
  const int zl = threadIdx.x / kParts;
  uint32_t v[kW];
  uint32_t present = 0;
#pragma unroll
  for (int b = 0; b < kW; ++b) {
    v[b] = stage[part * kW + b][zl];
    present |= (pos[part * kW + b] >= 0 ? 1u : 0u) << b;
  }
  int8_t* dst = db + groups[2 * g] + it * it_bytes + part * kW +
                static_cast<long long>((c * kN + zt * kZTile + zl) * 4) *
                    row_bytes;
  uint32_t w[4][kW / 4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
#pragma unroll
    for (int i = 0; i < kW / 4; ++i) w[l][i] = limb_word(v + 4 * i, l);
  }
  if (groups[2 * g + 1] == 0) {
    // a partial group: the four limbs' sectors loaded first, all at once
    uint32_t old[4][kW / 4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int8_t* o = dst + l * row_bytes;
      if constexpr (kW == 16) {
        const uint4 a = *reinterpret_cast<const uint4*>(o);
        old[l][0] = a.x; old[l][1] = a.y; old[l][2] = a.z; old[l][3] = a.w;
      } else if constexpr (kW == 8) {
        const uint2 a = *reinterpret_cast<const uint2*>(o);
        old[l][0] = a.x; old[l][1] = a.y;
      } else {
        old[l][0] = *reinterpret_cast<const uint32_t*>(o);
      }
    }
#pragma unroll
    for (int i = 0; i < kW / 4; ++i) {
      const uint32_t mask = byte_mask(present >> (4 * i));
#pragma unroll
      for (int l = 0; l < 4; ++l) w[l][i] = (w[l][i] & mask) | (old[l][i] & ~mask);
    }
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int8_t* o = dst + l * row_bytes;
    if constexpr (kW == 16) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
    } else if constexpr (kW == 8) {
      *reinterpret_cast<uint2*>(o) = make_uint2(w[l][0], w[l][1]);
    } else {
      *reinterpret_cast<uint32_t*>(o) = w[l][0];
    }
  }
}

cudaError_t launch_transform(long long rows, cudaStream_t st,
                             const uint8_t* src, const long long* order,
                             long long p0, const uint32_t* tb, uint32_t* out,
                             int chunks, int chunk_bytes, int n_coeffs,
                             int logp, uint32_t q0, uint32_t q1) {
  const unsigned nb = static_cast<unsigned>(rows * chunks * 2);
  // the word loads need every chunk 4-byte aligned (the base is, by the
  // wrapper); another chunk size reads its bytes one at a time
  if (logp == 8 && chunk_bytes % 4 == 0) {
    transform_kernel<true><<<nb, kGroup, 0, st>>>(
        src, order, p0, tb, out, chunks, chunk_bytes, n_coeffs, logp, q0, q1);
  } else {
    transform_kernel<false><<<nb, kGroup, 0, st>>>(
        src, order, p0, tb, out, chunks, chunk_bytes, n_coeffs, logp, q0, q1);
  }
  return cudaGetLastError();
}

cudaError_t launch_sectors(int members, long long groups_n, int chunks,
                           cudaStream_t st, const uint32_t* res,
                           const int* table, const long long* groups,
                           long long p0, int8_t* db, long long row_bytes,
                           long long it_bytes) {
  const long long blocks = groups_n * chunks * 2 * kZTiles;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (members) {
    case 32:
      sector_kernel<32><<<nb, kZTile * 2, 0, st>>>(
          res, table, groups, p0, db, groups_n, chunks, row_bytes, it_bytes);
      break;
    case 16:
      sector_kernel<16><<<nb, kZTile, 0, st>>>(
          res, table, groups, p0, db, groups_n, chunks, row_bytes, it_bytes);
      break;
    case 8:
      sector_kernel<8><<<nb, kZTile, 0, st>>>(
          res, table, groups, p0, db, groups_n, chunks, row_bytes, it_bytes);
      break;
    case 4:
      sector_kernel<4><<<nb, kZTile, 0, st>>>(
          res, table, groups, p0, db, groups_n, chunks, row_bytes, it_bytes);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// bytes: (K, chunks, chunk_bytes) uint8; tables: (2, 4, z) uint32 per
// channel (w, w', w_inv, w_inv'); p = 2^logp with logp <= 25 (a field fits
// the 4-byte window at any shift); z = 2^log_n = 2048.
//
// Without db (null): res is the output (K, chunks, 2, z) uint32, item k in
// row k; the other plan arguments are unused.
// With db (the dense DB tensor or the compact planes, int8 [c, z, l, jw,
// chunks, num_per, 4]): the plan of kv/ingest.py:sector_plan. order: (K)
// int64, the item at each position; table: (G, members) int32, the
// position of the member at each sector byte or -1; groups: (G, 2) int64,
// the byte offset of the group's sector in a (c, z, l) row at chunk 0 and
// whether the group is full; batches: HOST int64 (n_batches + 1, 2), the
// first group and first position of each batch and then (G, K); res: the
// scratch, at least the largest batch's positions x (chunks, 2, z) uint32;
// row_bytes = jw * chunks * num_per * 4, it_bytes = num_per * 4.
extern "C" int sdk_ingest(const void* bytes, const void* order,
                          const void* table, const void* groups,
                          const void* batches, int n_batches,
                          const void* tables, void* db, void* res,
                          long long K, int chunks, int chunk_bytes,
                          int n_coeffs, int logp, int members,
                          long long row_bytes, long long it_bytes, int log_n,
                          unsigned int q0, unsigned int q1, void* stream) {
  if (K <= 0 || chunks <= 0) return static_cast<int>(cudaGetLastError());
  if (logp < 1 || logp > 25 || log_n != kLogN || n_coeffs > kN ||
      K * chunks * 2 > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(bytes);
  const auto* tb = static_cast<const uint32_t*>(tables);
  auto* out = static_cast<uint32_t*>(res);

  if (db == nullptr) {
    return static_cast<int>(launch_transform(K, st, src, nullptr, 0, tb, out,
                                             chunks, chunk_bytes, n_coeffs,
                                             logp, q0, q1));
  }
  const auto* bt = static_cast<const long long*>(batches);
  const auto* ord = static_cast<const long long*>(order);
  const auto* tab = static_cast<const int*>(table);
  const auto* grp = static_cast<const long long*>(groups);
  for (int b = 0; b < n_batches; ++b) {
    const long long g0 = bt[2 * b], p0 = bt[2 * b + 1];
    const long long g1 = bt[2 * b + 2], p1 = bt[2 * b + 3];
    if (g1 <= g0 || p1 <= p0) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = launch_transform(p1 - p0, st, src, ord, p0, tb, out,
                                       chunks, chunk_bytes, n_coeffs, logp,
                                       q0, q1);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_sectors(members, g1 - g0, chunks, st, out,
                         tab + g0 * members, grp + 2 * g0, p0,
                         static_cast<int8_t*>(db), row_bytes, it_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
