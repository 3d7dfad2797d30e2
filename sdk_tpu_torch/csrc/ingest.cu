// Item ingest (kernel H), fused: chunk bytes -> mod-p coefficients -> NTT
// residues -> 7-bit limbs written in place into the resident index.
//
// Replaces sdk_tpu/kv/ingest.py:61 ingest_items_device and the scatter of
// DbUpdateBuffer.flush (sdk_tpu/kv/ingest.py:196-339: db_limbs_host + the
// donated .at[].set programs). The composed form made, per 1024 items of the
// 1 GiB bucket, 268 MB of int64 words, 134 MB of int32 residues and 268 MB of
// limbs on their way to an index_put; here none of them exists.
//
// One block per (item k, chunk it). Each thread extracts its coefficients'
// logp-bit fields from the chunk's little-endian bit stream (a 4-byte window
// read byte by byte, zero past the chunk's end; logp = 8 is one byte a
// coefficient), recentres them (w > p/2 -> w - p) into [0, q_c) for both
// channels, the block forward-NTTs both channels in 16 KB of shared memory
// (ntt_device.cuh), and then either
//   - splits every canonical residue into four 7-bit limbs and stores them
//     as int8 at [c, z, l, col/4, it, bin, col%4] of the dense DB tensor or
//     the compact planes (spiral.db_shape / compact_shape), or
//   - stores the residues (K, chunks, 2, z), which is what
//     ingest_items_device returns.
//
// What bounds it on the H100: the scattered stores. An item's chunk reads
// z bytes and writes 2*z*4 single bytes, each z-stride (JW*IT*NPR*16 bytes,
// 2 MB in the dense 1 GiB index) from the next, so no two stores of a block
// share a 32-byte sector and device memory sees a sector-sized
// read-modify-write for every byte unless L2 merges it first. A sector holds
// the bytes of 8 neighbouring bins x 4 columns of one (c, z, l, jw, it).
// flush hands the items over sorted by item index, whose low bits are the
// bin, so items k .. k+7 of a bulk load fill one sector between them. The
// grid therefore runs k fastest (block = it * K + k): blocks that are
// resident together work on neighbouring items of the same chunk index and
// write the same sectors at about the same time, which lets L2 gather a
// sector's bytes before it is evicted. (With `it` fastest the 16 chunks of
// one item would run together and touch 16 different sectors per store.)

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
ingest_kernel(const uint8_t* __restrict__ bytes,
              const long long* __restrict__ bins,
              const long long* __restrict__ cols,
              const uint32_t* __restrict__ tables, int8_t* __restrict__ db,
              uint32_t* __restrict__ out, long long K, int chunks,
              int chunk_bytes, int n_coeffs, int logp, long long jw,
              long long num_per, int log_n, uint32_t q0, uint32_t q1) {
  extern __shared__ uint32_t s[];   // (2, z)
  const int z = 1 << log_n;
  const long long k = blockIdx.x % K;
  const int it = static_cast<int>(blockIdx.x / K);
  const uint8_t* src = bytes + (k * chunks + it) * chunk_bytes;
  const uint32_t p = 1u << logp;
  for (int i = threadIdx.x; i < z; i += blockDim.x) {
    uint32_t w = 0;
    if (i < n_coeffs) {
      const long long bit = static_cast<long long>(logp) * i;
      const int b0 = static_cast<int>(bit >> 3);
      uint32_t win = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = b0 + b < chunk_bytes ? src[b0 + b] : 0u;
        win |= byte << (8 * b);
      }
      w = (win >> (bit & 7)) & (p - 1);
    }
    // recentre: w > p/2 stands for w - p
    const bool neg = w > p / 2;
    s[i] = neg ? q0 - (p - w) : w;
    s[z + i] = neg ? q1 - (p - w) : w;
  }
  __syncthreads();
  sdk::ntt_forward_smem(s, 2, 0, tables, log_n, q0, q1);
  if (out != nullptr) {
    uint32_t* o = out + (k * chunks + it) * 2 * z;
    for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
      o[idx] = sdk::ntt_canonical(s[idx], idx >> log_n ? q1 : q0);
    }
  }
  if (db != nullptr) {
    const long long bin = bins[k];
    const long long col = cols[k];
    // strides of (c, z, l, jw, it, bin, 4)
    const long long it_stride = num_per * 4;
    const long long l_stride = jw * chunks * it_stride;
    int8_t* base = db + ((col >> 2) * chunks + it) * it_stride + bin * 4 +
                   (col & 3);
    for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
      const uint32_t v = sdk::ntt_canonical(s[idx], idx >> log_n ? q1 : q0);
      int8_t* dst = base + static_cast<long long>(idx) * 4 * l_stride;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        dst[l * l_stride] = static_cast<int8_t>((v >> (7 * l)) & 127u);
      }
    }
  }
}

}  // namespace

// bytes: (K, chunks, chunk_bytes) uint8; bins, cols: (K) int64, item k goes
// to num_per bin bins[k] and column cols[k] (its dim0 index in the dense DB,
// its slot in the compact planes; the pairs are distinct). db: int8 (2, z, 4,
// jw, chunks, num_per, 4) or null; out: (K, chunks, 2, z) uint32 or null.
// p = 2^logp with logp <= 25 (a field fits the 4-byte window at any shift).
extern "C" int sdk_ingest(const void* bytes, const void* bins, const void* cols,
                          const void* tables, void* db, void* out, long long K,
                          int chunks, int chunk_bytes, int n_coeffs, int logp,
                          long long jw, long long num_per, int log_n,
                          unsigned int q0, unsigned int q1, void* stream) {
  const long long blocks = K * chunks;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (logp < 1 || logp > 25 || n_coeffs > (1 << log_n) ||
      blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (2 * sizeof(uint32_t)) << log_n;
  ingest_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bytes), static_cast<const long long*>(bins),
      static_cast<const long long*>(cols),
      static_cast<const uint32_t*>(tables), static_cast<int8_t*>(db),
      static_cast<uint32_t*>(out), K, chunks, chunk_bytes, n_coeffs, logp, jw,
      num_per, log_n, q0, q1);
  return static_cast<int>(cudaGetLastError());
}
