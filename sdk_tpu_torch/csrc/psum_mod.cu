// Exact sum of D partial tensors, reduced once (kernel M).
//
// Replaces sdk_tpu/ops/shard.py:42 psum_mod: the mod-q sum of the per-shard
// partial scan results over the mesh's "db" axis. The JAX program sums
// 16-bit halves with lax.psum so that the uint32 collective stays exact and
// recombines them with a Shoup multiply; that was a TPU workaround. Here
// every value is widened to 64 bits as it is read, the D values of an
// element are added in a uint64 (exact for any D < 2^32) and the sum is
// reduced once: mod q_c of the element's channel, or kept mod 2^32 (q = 0,
// the wrapping form of the checklist's h2 and answer sums).
//
// The parts are read through a table of D device pointers (copied to shared
// memory once per block), so the partials are never stacked into one
// tensor. Channel c covers elements [c * chan, (c + 1) * chan) of every
// part; two channels at most (the Spiral CRT pair).
//
// What bounds it on the H100: bytes. D reads and one write of 4 bytes an
// element; with every part on 16-byte boundaries each thread moves four
// elements a part with one 16-byte load. The one 64-bit remainder an element
// costs ~100 integer instructions, under the memory time at D >= 2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 64;

__device__ __forceinline__ uint32_t reduce(unsigned long long acc,
                                           uint32_t q) {
  return q == 0 ? static_cast<uint32_t>(acc)
                : static_cast<uint32_t>(acc % q);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
psum_mod_kernel(const int32_t* const* __restrict__ parts, int D,
                long long nvec, long long chan_vec, uint32_t q0, uint32_t q1,
                int32_t* __restrict__ out) {
  __shared__ const int32_t* sp[kMaxParts];
  for (int d = threadIdx.x; d < D; d += blockDim.x) sp[d] = parts[d];
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += step) {
    const uint32_t q = v < chan_vec ? q0 : q1;
    if constexpr (VEC == 4) {
      unsigned long long a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      for (int d = 0; d < D; ++d) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(sp[d]) + v);
        a0 += static_cast<uint32_t>(x.x);
        a1 += static_cast<uint32_t>(x.y);
        a2 += static_cast<uint32_t>(x.z);
        a3 += static_cast<uint32_t>(x.w);
      }
      int4 r;
      r.x = static_cast<int32_t>(reduce(a0, q));
      r.y = static_cast<int32_t>(reduce(a1, q));
      r.z = static_cast<int32_t>(reduce(a2, q));
      r.w = static_cast<int32_t>(reduce(a3, q));
      reinterpret_cast<int4*>(out)[v] = r;
    } else {
      unsigned long long a = 0;
      for (int d = 0; d < D; ++d) a += static_cast<uint32_t>(__ldg(sp[d] + v));
      out[v] = static_cast<int32_t>(reduce(a, q));
    }
  }
}

}  // namespace

// parts: device array of D pointers to int32 tensors of n elements each;
// out: n int32. Elements [0, chan) are reduced mod q0 and [chan, n) mod q1
// (q = 0: mod 2^32). vec4 != 0: every pointer is 16-byte aligned and n and
// chan are multiples of 4.
extern "C" int sdk_psum_mod(const void* parts, int D, long long n,
                            long long chan, unsigned int q0, unsigned int q1,
                            int vec4, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (D < 1 || D > kMaxParts || chan < 0 || chan > n ||
      (vec4 && (n % 4 || chan % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = vec4 ? 4 : 1;
  const long long nvec = n / vec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto p = static_cast<const int32_t* const*>(parts);
  auto o = static_cast<int32_t*>(out);
  if (vec4) {
    psum_mod_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, D, nvec, chan / 4, q0, q1, o);
  } else {
    psum_mod_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, D, nvec, chan, q0, q1, o);
  }
  return static_cast<int>(cudaGetLastError());
}
