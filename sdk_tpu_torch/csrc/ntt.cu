// Negacyclic NTT, forward and inverse, over one CRT channel of 2048-point
// polynomials: one polynomial a 128-thread block.
//
// Replaces: sdk_tpu/ops/ntt_jax.py:199 ntt_forward (stages _fwd_channel_poly
// :113 / _fwd_channel :63) and sdk_tpu/ops/ntt_jax.py:215 ntt_inverse
// (stages _inv_channel_poly :142 / _inv_channel :88).
//
// Arithmetic: the Harvey butterflies of ntt_device.cuh. The forward kernel
// takes any uint32: the lazy butterflies take [0, 4q), and a value above
// that is reduced mod q as it is loaded, so the result equals the exact
// transform of the input mod q, as the plain version's and the JAX NTT's
// does. Outputs are canonical in [0, q).
//
// What bounds it on the H100: integer issue and latency, not HBM. A
// transform is 11 x 1024 butterflies of six integer instructions against 16
// KB of device traffic; a whole polynomial a 512-thread block with a barrier
// a stage and two global twiddle loads a butterfly reached 23% of the byte
// bound at 8,192 polynomials, and a small launch paid its 11-barrier chain.
// So it runs on the transform core (ntt_device.cuh, sdk::core): 16
// coefficients a thread in registers, three passes of 3-4 stages with a
// stage's twiddles read once as one or two vector loads, two exchanges
// through a padded shared buffer. The forward stages its input through
// shared memory so that it loads 16 bytes a thread (three barriers a
// transform); the inverse loads its input straight into the core's first
// layout with 16-byte loads and stores int32 pairs (two barriers). One
// polynomial a 128-thread block: two or four a block were 5-20% slower at
// every count of the read path (tools/scan_bench_gpu.py --kernel ntt,
// PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

using namespace sdk::core;

template <bool kInverse>
__global__ void __launch_bounds__(kGroup, 8)
ntt_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           const uint32_t* __restrict__ tables, uint32_t q0, uint32_t q1) {
  __shared__ __align__(16) uint32_t buf_a[kPad];
  __shared__ __align__(16) uint32_t buf_b[kPad];
  const int j = threadIdx.x;
  const long long poly = blockIdx.x;              // (batch, channel)
  const int c = static_cast<int>(poly & 1);
  const uint32_t q = c ? q1 : q0;
  const uint32_t* tbl = tables + static_cast<size_t>(c) * 4 * kN;
  const uint32_t* x = in + poly * kN;
  uint32_t* y = out + poly * kN;
  uint32_t v[kPer];
  if constexpr (kInverse) {
    // Lc straight from device memory
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(x + lc_base(j)) + h);
      v[4 * h] = a.x; v[4 * h + 1] = a.y; v[4 * h + 2] = a.z; v[4 * h + 3] = a.w;
    }
    inverse(v, buf_a, buf_b, j, 0, tbl, q);
#pragma unroll
    for (int h = 0; h < kPer / 2; ++h) {     // La: pairs 2j, 2j + 1
      reinterpret_cast<uint2*>(y + la_base(j) + la_off(2 * h))[0] =
          make_uint2(sdk::ntt_canonical(v[2 * h], q),
                     sdk::ntt_canonical(v[2 * h + 1], q));
    }
  } else {
    // 16-byte loads of words 4j + 512r .. +3, staged to La through buf_b
    const int sb = pad(4 * j);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + j + 128 * r);
      buf_b[sb + pad(512 * r)] = sdk::ntt_input(a.x, q);
      buf_b[sb + pad(512 * r + 1)] = sdk::ntt_input(a.y, q);
      buf_b[sb + pad(512 * r + 2)] = sdk::ntt_input(a.z, q);
      buf_b[sb + pad(512 * r + 3)] = sdk::ntt_input(a.w, q);
    }
    __syncthreads();
    from_smem<0>(buf_b, j, v);
    forward(v, buf_a, buf_b, j, 0, tbl, q);
#pragma unroll
    for (int h = 0; h < kPer / 4; ++h) {
      reinterpret_cast<uint4*>(y + lc_base(j))[h] = make_uint4(
          sdk::ntt_canonical(v[4 * h], q), sdk::ntt_canonical(v[4 * h + 1], q),
          sdk::ntt_canonical(v[4 * h + 2], q),
          sdk::ntt_canonical(v[4 * h + 3], q));
    }
  }
}

}  // namespace

// in/out: (npolys, n) uint32 with npolys = batch * 2 (channel minor), n =
// 2048, 16-byte aligned; tables: (2, 4, n) uint32 = per channel (w, w',
// w_inv, w_inv').
extern "C" int sdk_ntt(const void* in, void* out, const void* tables,
                       long long npolys, int log_n, unsigned int q0,
                       unsigned int q1, int inverse, void* stream) {
  if (npolys <= 0) return static_cast<int>(cudaGetLastError());
  if (log_n != sdk::core::kLogN || npolys > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  const auto* tb = static_cast<const uint32_t*>(tables);
  const auto kernel = inverse ? ntt_kernel<true> : ntt_kernel<false>;
  kernel<<<static_cast<unsigned>(npolys), sdk::core::kGroup, 0, st>>>(
      x, y, tb, q0, q1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sdk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
