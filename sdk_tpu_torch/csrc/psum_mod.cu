// Exact sum of D partial tensors, reduced once (kernel M).
//
// Replaces sdk_tpu/ops/shard.py:42 psum_mod: the mod-q sum of the per-shard
// partial scan results over the mesh's "db" axis. The JAX program sums
// 16-bit halves with lax.psum so that the uint32 collective stays exact and
// recombines them with a Shoup multiply; that was a TPU workaround. Here
// every value is widened to 64 bits as it is read, the D values of an
// element are added in a uint64 (hi * 2^32 + lo with hi < D <= 64) and the
// sum is reduced once: mod q_c of the element's channel, or kept mod 2^32
// (q = 0, the wrapping form of the checklist's h2 and answer sums).
//
// The D part pointers are a kernel parameter (a __grid_constant__ struct of
// 64 pointers, 512 bytes), so a call copies nothing to the device and the
// partials are never stacked into one tensor. Channel c covers elements
// [c * chan, (c + 1) * chan) of every part; two channels at most (the
// Spiral CRT pair).
//
// The reduction has no 64-bit `%` (a ~100-instruction subroutine): with
// per-channel constants worked out on the host, r = 2^32 mod q and m =
// floor((2^64 - 1) / q), t = hi * r + lo (< 2^38, congruent to the sum) and
// a Barrett quotient __umul64hi(t, m), which falls short of floor(t / q)
// by at most 1, leave t - quotient * q in [0, 2q): one conditional
// subtraction.
//
// What bounds it on the H100: bytes. D reads and one write of 4 bytes an
// element; with every part on 16-byte boundaries each thread moves four
// elements a part with one 16-byte load, two independent loads a part in
// flight (two neighbouring vectors). A block takes 512 vectors, the grid as
// many blocks as that needs, up to 32 waves of the occupancy query, past
// which the blocks stride. The channels' constants sit in shared memory,
// read where they are used rather than held in registers through the loop
// (registers bound the blocks an SM).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 64;
constexpr int kMaxWaves = 32;

struct Parts {
  const int32_t* p[kMaxParts];
};

// One channel's modulus and its reduction constants (q = 0: mod 2^32).
struct Channel {
  uint32_t q, r;           // r = 2^32 mod q
  unsigned long long m;    // floor((2^64 - 1) / q)
};

__device__ __forceinline__ uint32_t reduce(unsigned long long acc,
                                           const Channel& c) {
  const uint32_t lo = static_cast<uint32_t>(acc);
  if (c.q == 0) return lo;
  const unsigned long long t =
      static_cast<unsigned long long>(static_cast<uint32_t>(acc >> 32)) * c.r +
      lo;
  const unsigned long long s = t - __umul64hi(t, c.m) * c.q;
  return static_cast<uint32_t>(s >= c.q ? s - c.q : s);
}

__device__ __forceinline__ void add4(unsigned long long (&a)[4], int4 x) {
  a[0] += static_cast<uint32_t>(x.x);
  a[1] += static_cast<uint32_t>(x.y);
  a[2] += static_cast<uint32_t>(x.z);
  a[3] += static_cast<uint32_t>(x.w);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
psum_mod_kernel(const __grid_constant__ Parts parts, int D, long long nvec,
                long long chan_vec, const Channel ch0, const Channel ch1,
                int32_t* __restrict__ out) {
  // the channels' constants in shared memory: read where they are used,
  // not held in registers through the loop
  __shared__ Channel chans[2];
  if (threadIdx.x == 0) {
    chans[0] = ch0;
    chans[1] = ch1;
  }
  __syncthreads();
  const Channel& c0 = chans[0];
  const Channel& c1 = chans[1];
  // a block takes 2 x 256 neighbouring vectors an iteration: thread v and
  // w = v + 256, two independent loads a part in flight (w reads v again
  // past the end, and is not stored)
  const long long step = 2LL * gridDim.x * kThreads;
  for (long long v = 2LL * blockIdx.x * kThreads + threadIdx.x; v < nvec;
       v += step) {
    const bool two = v + kThreads < nvec;
    const long long w = two ? v + kThreads : v;
    if constexpr (VEC == 4) {
      unsigned long long a[4] = {0, 0, 0, 0}, b[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const int4* src = reinterpret_cast<const int4*>(parts.p[d]);
        add4(a, __ldg(src + v));
        add4(b, __ldg(src + w));
      }
      const Channel& ca = v < chan_vec ? c0 : c1;
      reinterpret_cast<int4*>(out)[v] = make_int4(
          reduce(a[0], ca), reduce(a[1], ca), reduce(a[2], ca),
          reduce(a[3], ca));
      if (two) {
        const Channel& cb = w < chan_vec ? c0 : c1;
        reinterpret_cast<int4*>(out)[w] = make_int4(
            reduce(b[0], cb), reduce(b[1], cb), reduce(b[2], cb),
            reduce(b[3], cb));
      }
    } else {
      unsigned long long a = 0, b = 0;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        a += static_cast<uint32_t>(__ldg(parts.p[d] + v));
        b += static_cast<uint32_t>(__ldg(parts.p[d] + w));
      }
      out[v] = static_cast<int32_t>(reduce(a, v < chan_vec ? c0 : c1));
      if (two) out[w] = static_cast<int32_t>(reduce(b, w < chan_vec ? c0 : c1));
    }
  }
}

// Blocks of kMaxWaves waves of the kernel (SMs x blocks an SM), the most a
// launch takes (more work strides), once a device.
template <int VEC>
int max_blocks() {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < kMaxDevices && cached[dev].load(std::memory_order_acquire) > 0)
    return cached[dev].load(std::memory_order_acquire);
  int sms = 0, bps = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &bps, psum_mod_kernel<VEC>, kThreads, 0) != cudaSuccess ||
      bps < 1)
    return -1;
  if (dev < kMaxDevices)
    cached[dev].store(kMaxWaves * sms * bps, std::memory_order_release);
  return kMaxWaves * sms * bps;
}

}  // namespace

// parts: a host array of D device pointers to int32 tensors of n elements
// each; out: n int32. Elements [0, chan) are reduced mod q0 and [chan, n)
// mod q1 (q = 0: mod 2^32), r_c = 2^32 mod q_c and m_c = floor((2^64 - 1) /
// q_c) (ops/shard.py reduction_constants). vec4 != 0: every pointer is
// 16-byte aligned and n and chan are multiples of 4.
extern "C" int sdk_psum_mod(const void* const* parts, int D, long long n,
                            long long chan, unsigned int q0, unsigned int r0,
                            unsigned long long m0, unsigned int q1,
                            unsigned int r1, unsigned long long m1, int vec4,
                            void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (D < 1 || D > kMaxParts || chan < 0 || chan > n ||
      (vec4 && (n % 4 || chan % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts p{};
  for (int d = 0; d < D; ++d) p.p[d] = static_cast<const int32_t*>(parts[d]);
  const Channel c0{q0, r0, m0}, c1{q1, r1, m1};
  const int vec = vec4 ? 4 : 1;
  const long long nvec = n / vec;
  const int most = vec4 ? max_blocks<4>() : max_blocks<1>();
  if (most < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // a block a 512 vectors, up to kMaxWaves waves of the occupancy query
  long long blocks = (nvec + 2LL * kThreads - 1) / (2LL * kThreads);
  if (blocks > most) blocks = most;
  const auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<int32_t*>(out);
  if (vec4) {
    psum_mod_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, D, nvec, chan / 4, c0, c1, o);
  } else {
    psum_mod_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        p, D, nvec, chan, c0, c1, o);
  }
  return static_cast<int>(cudaGetLastError());
}
