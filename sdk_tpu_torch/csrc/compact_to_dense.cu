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
// Two kernels, one launch of the entry point:
//   - inverse: one block per bin builds the inverse map inv[j/4, b, j%4] =
//     the slot that lands on column j of bin b, or -1 (int16; jw * num_per *
//     4 entries, 64 KB at the 1 GiB bucket), so that
//   - gather: one thread per 4-byte output word (bin b, columns 4*jw .. +3,
//     of one (c, z, l) row and one it) reads its four inverse entries with
//     one 8-byte load and, for the occupied ones, the slot's byte of the
//     compact planes, and stores the word. Every byte of the dense index is
//     written exactly once, in order, so there is no memset, no race and no
//     read-modify-write; a word whose four columns are all empty (most of
//     them at 1/8 fill) stores zero without touching the planes.
//
// What bounds it on the H100: bytes, the dense index written once (8.59 GB
// at the 1 GiB bucket) and the compact planes read once (2.15 GB at cap
// 128). The planes' bytes are read singly, scattered over one (c, z, l)
// row's cap/4 slot words (131 KB at cap 128), which L1 and L2 absorb.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void inverse_kernel(const int32_t* __restrict__ idx_j,
                               const int32_t* __restrict__ counts,
                               int16_t* __restrict__ inv, int cap, int jw,
                               int npr) {
  const int b = blockIdx.x;
  const int dim0 = 4 * jw;
  for (int j = threadIdx.x; j < dim0; j += blockDim.x) {
    inv[((j >> 2) * npr + b) * 4 + (j & 3)] = -1;
  }
  __syncthreads();
  const int n = min(counts[b], cap);
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int j = idx_j[b * cap + s];
    if (j >= 0 && j < dim0) {
      inv[((j >> 2) * npr + b) * 4 + (j & 3)] = static_cast<int16_t>(s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int8_t* __restrict__ planes,
              const int16_t* __restrict__ inv, int8_t* __restrict__ dense,
              long long rows, int cw, int jw, int it_n, int npr) {
  const unsigned row_words = static_cast<unsigned>(jw) * it_n * npr;
  const long long in_row = 4LL * cw * it_n * npr;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const int8_t* src = planes + row * in_row;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dense) + row * row_words;
    for (unsigned w = blockIdx.x * blockDim.x + threadIdx.x; w < row_words;
         w += gridDim.x * blockDim.x) {
      const unsigned b = w % npr;
      const unsigned rest = w / npr;
      const unsigned it = rest % it_n;
      const unsigned jwi = rest / it_n;
      const uint2 sl = __ldg(reinterpret_cast<const uint2*>(
          inv + (static_cast<long long>(jwi) * npr + b) * 4));
      uint32_t out = 0;
      if ((sl.x & sl.y) != 0xFFFFFFFFu) {
        const uint32_t packed[2] = {sl.x, sl.y};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int s = static_cast<int16_t>(packed[t >> 1] >> (16 * (t & 1)));
          if (s >= 0) {
            const uint8_t v = static_cast<uint8_t>(__ldg(
                src + ((static_cast<long long>(s >> 2) * it_n + it) * npr +
                       b) * 4 + (s & 3)));
            out |= static_cast<uint32_t>(v) << (8 * t);
          }
        }
      }
      dst[w] = out;
    }
  }
}

}  // namespace

// planes: int8 (rows, cw, it_n, npr, 4) with rows = crt * z * L (the compact
// planes, cap = 4 * cw slots); idx_j: int32 (npr, cap); counts: int32 (npr),
// the occupied slots [0, counts[b]) of each bin; inv: int16 scratch of jw *
// npr * 4 entries; dense: int8 (rows, jw, it_n, npr, 4), every byte written.
extern "C" int sdk_compact_to_dense(const void* planes, const void* idx_j,
                                    const void* counts, void* inv, void* dense,
                                    long long rows, int cw, int jw, int it_n,
                                    int npr, void* stream) {
  const long long row_words = static_cast<long long>(jw) * it_n * npr;
  if (rows <= 0 || row_words <= 0) return static_cast<int>(cudaGetLastError());
  if (cw <= 0 || 4LL * cw > 32767 || row_words > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  inverse_kernel<<<npr, kThreads, 0, s>>>(
      static_cast<const int32_t*>(idx_j), static_cast<const int32_t*>(counts),
      static_cast<int16_t*>(inv), 4 * cw, jw, npr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long long bx = (row_words + kThreads - 1) / kThreads;
  if (bx > 1024) bx = 1024;
  const long long by = rows < 65535 ? rows : 65535;
  gather_kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)),
                  kThreads, 0, s>>>(
      static_cast<const int8_t*>(planes), static_cast<const int16_t*>(inv),
      static_cast<int8_t*>(dense), rows, cw, jw, it_n, npr);
  return static_cast<int>(cudaGetLastError());
}
