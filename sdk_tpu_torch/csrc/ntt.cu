// Negacyclic NTT, forward and inverse, over one CRT channel of one
// 2048-point polynomial per block.
//
// Replaces: sdk_tpu/ops/ntt_jax.py:199 ntt_forward (stages _fwd_channel_poly
// :113 / _fwd_channel :63) and sdk_tpu/ops/ntt_jax.py:215 ntt_inverse
// (stages _inv_channel_poly :142 / _inv_channel :88).
//
// Arithmetic: the Harvey butterflies of ntt_device.cuh (shared with the
// fused kernels). The forward kernel takes any uint32: the lazy butterflies
// take [0, 4q), and a value above that is reduced mod q as it is loaded, so
// the result equals the exact transform of the input mod q, as the plain
// version's and the JAX NTT's does. Outputs are canonical in [0, q).
//
// What bounds it on the H100: integer ops. A 2048-point transform is 11
// stages x 1024 butterflies of ~8 integer instructions against 16 KB of
// device traffic (load + store of 2048 u32), i.e. ~5 int ops per byte, so
// the SM's integer pipes, shared-memory bandwidth and the stage barriers
// bound it, not HBM. The design keeps the whole polynomial (8 KB) in shared
// memory for all 11 stages, so device memory is read and written exactly
// once; __umulhi gives the Shoup high half in one instruction (the TPU build
// emulated it with four 16-bit products, modops.py:35); each thread runs two
// independent butterflies per stage between barriers.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kInverse>
__global__ void ntt_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out,
                           const uint32_t* __restrict__ tables, int log_n,
                           uint32_t q0, uint32_t q1) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const long long poly = blockIdx.x;       // flat (batch, channel) index
  const int c = static_cast<int>(poly & 1);
  const uint32_t q = c ? q1 : q0;
  const uint32_t* x = in + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s[i] = kInverse ? x[i] : sdk::ntt_input(x[i], q);
  }
  __syncthreads();
  if (kInverse) {
    sdk::ntt_inverse_smem(s, 1, c, tables, log_n, q0, q1);
  } else {
    sdk::ntt_forward_smem(s, 1, c, tables, log_n, q0, q1);
  }
  uint32_t* y = out + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    y[i] = sdk::ntt_canonical(s[i], q);
  }
}

}  // namespace

// in/out: (npolys, n) uint32 with npolys = batch * 2 (channel minor);
// tables: (2, 4, n) uint32 = per channel (w, w', w_inv, w_inv').
extern "C" int sdk_ntt(const void* in, void* out, const void* tables,
                       long long npolys, int log_n, unsigned int q0,
                       unsigned int q1, int inverse, void* stream) {
  if (npolys <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = sizeof(uint32_t) << log_n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  const auto* tb = static_cast<const uint32_t*>(tables);
  if (inverse) {
    ntt_kernel<true><<<static_cast<unsigned>(npolys), kThreads, smem, st>>>(
        x, y, tb, log_n, q0, q1);
  } else {
    ntt_kernel<false><<<static_cast<unsigned>(npolys), kThreads, smem, st>>>(
        x, y, tb, log_n, q0, q1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sdk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
