// Dense migration of a compact index (kernel H').
//
// Replaces sdk_tpu/kv/ingest.py:161 compact_to_dense: every occupied slot s
// of num_per bin b moves to its dim0 column j = idx_j[b, s],
//   dense[c, z, l, j/4, it, b, j%4] = planes[c, z, l, s/4, it, b, s%4],
// and every other byte of the dense index is zero. The JAX program (and the
// port's plain version) scatter-ADD every slot into a zeroed tensor, so the
// unoccupied slots, which carry idx_j 0 and zero limbs, add nothing. A byte
// store cannot add (there is no byte atomic), and an unoccupied slot that
// stored its zeros would wipe column 0 of its bin; so only the occupied
// slots s < counts[b] (slots are handed out in order and never freed,
// kv/ingest.CompactSlots) are placed.
//
// One kernel: a block owns one tile (it_t chunks x jw_t column words,
// kv/ingest.py:migrate_tiling) and walks the index's (c, z, l) rows (2 *
// 2048 * 4 at the 1 GiB bucket), as many blocks as the card holds at once.
// Once, it lists the occupied slots whose column falls in its tile, each
// as the byte it reads in a row's stage and the byte it writes in the
// tile. For each row it copies the row's compact slice [slot word][it_t]
// [num_per][4] into shared memory with 16-byte cp.async (two buffers: the
// next row's copy runs under this row's work; slot words past the fullest
// bin's count are never read), scatters the listed slots' bytes into the
// dense tile [jw_t][it_t][num_per][4] assembled in shared memory (zero
// elsewhere), and streams the tile out with 16-byte loads and stores,
// neighbouring threads on neighbouring 16 bytes, zeroing it behind them
// for the next row. A first form looked up every dense byte in an inverse
// map instead: ~16 shared-memory byte loads a 16-byte store, bound by
// shared memory on the H100 (PERF.md); the scatter touches only the
// occupied slots, ~11% of the bytes at the S2 state.
//
// Every byte of the dense index is written exactly once: no memset, no
// race, no read-modify-write.
//
// What bounds it on the H100: bytes, the dense index written once (8.59 GB
// at the 1 GiB bucket). The planes are read once, whole slot words up to
// the fullest bin's count: at the S2 state (cap 128, ~55 items a bin) more
// than the occupied slots' bytes, which the bound counts.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the opt-in limit of dynamic shared memory (227 KB) less the static n_list
constexpr int kMaxSmem = 226 * 1024;

// 16-byte asynchronous copy global -> shared (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Tiling {
  long long rows;    // (c, z, l) rows
  int cw;            // slot words of a compact row
  int cw_used;       // slot words staged: ceil(max count / 4)
  int it_n, jw;      // chunks; column words of a dense row
  int log_npr, log_it_t, log_jw_t;
  int it_tiles;      // it_n / it_t
  int list_max;      // slots the list holds: npr * min(4 cw_used, 4 jw_t)
};

__global__ void __launch_bounds__(kThreads)
rows_kernel(const int8_t* __restrict__ planes,
            const int32_t* __restrict__ idx_j,
            const int32_t* __restrict__ counts, int8_t* __restrict__ dense,
            Tiling t) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int n_list;
  const int npr = 1 << t.log_npr;
  const int cap = 4 * t.cw;
  const int it0 = (blockIdx.x % t.it_tiles) << t.log_it_t;
  const int jw0 = (blockIdx.x / t.it_tiles) << t.log_jw_t;
  const int log_run = t.log_it_t + t.log_npr + 2;   // bytes of a column word's
  const int log_upj = log_run - 4;                  // run [it_t][npr][4]
  const int tile_bytes = 1 << (t.log_jw_t + log_run);
  const int stage_bytes = t.cw_used << log_run;
  uint4* tile = reinterpret_cast<uint4*>(smem);
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + tile_bytes);
  uint8_t* const stage0 = smem + tile_bytes + ((4 * t.list_max + 15) & ~15);

  // the tile starts zero; the copy-out zeroes what it has read
  for (int u = threadIdx.x; u < tile_bytes / 16; u += kThreads) {
    tile[u] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) n_list = 0;
  __syncthreads();
  // the occupied slots s < counts[b] whose column j lies in the tile, as
  // (stage byte | tile byte << 16) of chunk it0 (distinct columns a bin:
  // at most min(4 cw_used, 4 jw_t) of them a bin). Taken bin fastest, so
  // that neighbouring entries, which a warp's lanes scatter together, are
  // of neighbouring bins: both their stage and their tile bytes lie on
  // distinct banks (a bin's bytes share one bank in both layouts).
  for (int i = threadIdx.x; i < npr * cap; i += kThreads) {
    const int b = i & (npr - 1), s = i >> t.log_npr;
    if (s >= min(counts[b], cap)) continue;
    const int j = idx_j[b * cap + s];
    const int jl = (j >> 2) - jw0;
    if (j < 0 || j >= 4 * t.jw || jl < 0 || jl >= (1 << t.log_jw_t)) continue;
    const uint32_t src =
        ((s >> 2) << log_run) + (b << 2) + (s & 3);
    const uint32_t dst = (jl << log_run) + (b << 2) + (j & 3);
    const int at = atomicAdd(&n_list, 1);
    if (at < t.list_max) list[at] = src | (dst << 16);
  }
  __syncthreads();
  const int n = min(n_list, t.list_max);
  const int it_t = 1 << t.log_it_t;
  const int it_bytes = npr * 4;                      // a chunk in stage, tile
  const long long row_it = static_cast<long long>(t.it_n) * npr * 4;
  const long long in_row = t.cw * row_it;
  const long long out_row = t.jw * row_it;
  const int copies = t.cw_used << log_upj;
  const int upj_mask = (1 << log_upj) - 1;

  auto load = [&](long long row, uint8_t* dst) {
    const int8_t* src =
        planes + row * in_row + static_cast<long long>(it0) * npr * 4;
    for (int ch = threadIdx.x; ch < copies; ch += kThreads) {
      cp_async16(dst + 16 * ch,
                 src + (ch >> log_upj) * row_it + 16 * (ch & upj_mask));
    }
    cp_async_commit();
  };

  long long row = blockIdx.y;
  if (row < t.rows) load(row, stage0);
  for (int buf = 0; row < t.rows; row += gridDim.y, buf ^= 1) {
    if (row + gridDim.y < t.rows) {
      load(row + gridDim.y, stage0 + (buf ^ 1) * stage_bytes);
    } else {
      cp_async_commit();          // an empty group: wait_group 1 still waits
    }                             // for this row's
    cp_async_wait1();
    __syncthreads();              // this row's stage visible, the tile zero
    const uint8_t* st = stage0 + buf * stage_bytes;
    uint8_t* tb = smem;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t e = list[i];
      const int src = e & 0xFFFFu, dst = e >> 16;
      for (int il = 0; il < it_t; ++il) {
        tb[dst + il * it_bytes] = st[src + il * it_bytes];
      }
    }
    __syncthreads();              // the tile assembled
    int8_t* out =
        dense + row * out_row + static_cast<long long>(it0) * npr * 4;
    for (int u = threadIdx.x; u < tile_bytes / 16; u += kThreads) {
      const uint4 v = tile[u];
      tile[u] = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(out + (jw0 + (u >> log_upj)) * row_it +
                                16 * (u & upj_mask)) = v;
    }
  }
}

cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// planes: int8 (rows, cw, it_n, npr, 4) with rows = crt * z * L (the compact
// planes, cap = 4 * cw slots); idx_j: int32 (npr, cap); counts: int32 (npr),
// the occupied slots [0, counts[b]) of each bin, whose columns are
// distinct; dense: int8 (rows, jw, it_n, npr, 4), every byte written.
// cw_used: slot words staged (ceil of the largest count / 4, at most cw);
// the tile: it_t = 2^log_it_t chunks (dividing it_n, it_t * npr >= 4) x
// jw_t = 2^log_jw_t column words (dividing jw); npr = 2^log_npr; list_max
// = npr * min(4 cw_used, 4 jw_t).
extern "C" int sdk_compact_to_dense(const void* planes, const void* idx_j,
                                    const void* counts, void* dense,
                                    long long rows, int cw, int cw_used,
                                    int jw, int it_n, int log_npr,
                                    int log_it_t, int log_jw_t, int list_max,
                                    void* stream) {
  if (rows <= 0 || jw <= 0 || it_n <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int npr = 1 << log_npr;
  const int it_t = 1 << log_it_t, jw_t = 1 << log_jw_t;
  const long long tile = 4LL * jw_t * it_t * npr;
  const long long stage = 4LL * cw_used * it_t * npr;
  if (cw <= 0 || 4LL * cw > 32767 || cw_used < 0 || cw_used > cw ||
      log_npr < 0 || log_npr > 16 || it_n % it_t || jw % jw_t ||
      it_t * npr < 4 || tile > 65536 || stage > 65536 || list_max < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = tile + ((4LL * list_max + 15) & ~15LL) + 2 * stage;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_kernel, kThreads, static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Tiling t{rows, cw, cw_used, it_n, jw, log_npr, log_it_t, log_jw_t,
                 it_n / it_t, list_max};
  const long long tiles = static_cast<long long>(t.it_tiles) * (jw / jw_t);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  // one wave of blocks, the rows split among a tile's blocks
  long long by = (static_cast<long long>(sms) * per_sm + tiles - 1) / tiles;
  by = by < rows ? by : rows;
  by = by < 65535 ? by : 65535;
  rows_kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(by)),
                kThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const int8_t*>(planes), static_cast<const int32_t*>(idx_j),
      static_cast<const int32_t*>(counts), static_cast<int8_t*>(dense), t);
  return static_cast<int>(cudaGetLastError());
}
