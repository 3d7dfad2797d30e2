// NTT-domain modular matrix product: at every coefficient z and CRT channel
// c, out[b, i, j] = sum_k a[b / rep, i, k] * b[b, k, j] mod q_c.
//
// Replaces: sdk_tpu/ops/spiral_jax.py:108 matmul_mod (with _sum_mod :89 and
// the Shoup-keyed product shoup_mulmod_var_lazy, sdk_tpu/ops/modops.py:69).
// It carries the fold (spiral_jax.py:870), the expansion key product (:566),
// regev_to_gsw (:792) and the pack key products (:894, :901, :908).
//
// What bounds it on the H100: integer ops. Each output coefficient costs k
// products (k <= 28 at the 1 GiB bucket) plus one 64-bit reduction, against
// 4(k+1) bytes of operand traffic per product pair that neighbouring threads
// share through L1, so the integer pipes (64-bit multiply and the modulo are
// multi-instruction sequences) bound it before HBM does at these k. The
// design: one thread per output coefficient, with z the fastest index so a
// warp reads 32 consecutive words of every operand row (coalesced); the k
// loop accumulates exact products in a uint64 (k * 2^56 < 2^64 for k <= 256)
// and reduces once. Shoup-keyed operands (session key material with a
// precomputed w' = floor(w * 2^32 / q)) use one __umulhi and two 32-bit
// multiplies per term instead of a 64-bit product: each term is in [0, 2q).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void matmul_mod_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ a_shoup,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out,
                                  long long total, long long rep, int ra,
                                  int k, int cb, int n, uint32_t q0,
                                  uint32_t q1) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int z = static_cast<int>(idx % n);
  long long r = idx / n;
  const int c = static_cast<int>(r & 1);
  r >>= 1;
  const int j = static_cast<int>(r % cb);
  r /= cb;
  const int i = static_cast<int>(r % ra);
  const long long bat = r / ra;
  const uint32_t q = c ? q1 : q0;
  // a: (A, ra, k, 2, n); b: (B, k, cb, 2, n)
  const long long a_off = (((bat / rep) * ra + i) * k * 2 + c) * n + z;
  const long long a_step = 2LL * n;
  const long long b_off = ((bat * k * cb + j) * 2 + c) * n + z;
  const long long b_step = 2LL * cb * n;
  uint64_t acc = 0;
  if (a_shoup != nullptr) {
    for (int kk = 0; kk < k; ++kk) {
      const uint32_t w = a[a_off + kk * a_step];
      const uint32_t ws = a_shoup[a_off + kk * a_step];
      const uint32_t y = b[b_off + kk * b_step];
      acc += w * y - __umulhi(y, ws) * q;
    }
  } else {
    for (int kk = 0; kk < k; ++kk) {
      acc += static_cast<uint64_t>(a[a_off + kk * a_step]) *
             b[b_off + kk * b_step];
    }
  }
  out[idx] = static_cast<uint32_t>(acc % q);
}

}  // namespace

// a, a_shoup: (A, ra, k, 2, n) uint32 (a_shoup may be null); b: (B, k, cb,
// 2, n) uint32 with B = A * rep; out: (B, ra, cb, 2, n) uint32.
extern "C" int sdk_matmul_mod(const void* a, const void* a_shoup,
                              const void* b, void* out, long long nbatch,
                              long long rep, int ra, int k, int cb, int n,
                              unsigned int q0, unsigned int q1, void* stream) {
  const long long total = nbatch * ra * cb * 2LL * n;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (total + kThreads - 1) / kThreads;
  matmul_mod_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(a_shoup),
      static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), total, rep,
      ra, k, cb, n, q0, q1);
  return static_cast<int>(cudaGetLastError());
}
