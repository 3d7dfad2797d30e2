// Negacyclic NTT, forward and inverse, over one CRT channel of one
// 2048-point polynomial per block.
//
// Replaces: sdk_tpu/ops/ntt_jax.py:199 ntt_forward (stages _fwd_channel_poly
// :113 / _fwd_channel :63) and sdk_tpu/ops/ntt_jax.py:215 ntt_inverse
// (stages _inv_channel_poly :142 / _inv_channel :88).
//
// Arithmetic: the Harvey butterflies of the reference (ntt_host.py:20-77)
// with Shoup-scaled twiddles from params.ntt_tables, in wrapping uint32:
// w*y - mulhi(y, w')*q is exact because the true difference is < 2q < 2^30.
// Twiddles are indexed [m : 2m] per stage and the output is in ntt_host
// order; the inverse's halving step (x + q*(t&1)) >> 1 carries the 1/n.
// Forward inputs must be < 4q (reduced residues or gadget digits < 2^19);
// outputs are canonical in [0, q).
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

namespace {

constexpr int kThreads = 512;

__global__ void ntt_forward_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ tables,
                                   int log_n, uint32_t q0, uint32_t q1) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const long long poly = blockIdx.x;       // flat (batch, channel) index
  const int c = static_cast<int>(poly & 1);
  const uint32_t q = c ? q1 : q0;
  const uint32_t two_q = 2u * q;
  const uint32_t* w_tbl = tables + static_cast<size_t>(c) * 4 * n;
  const uint32_t* wp_tbl = w_tbl + n;
  const uint32_t* x = in + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[i];
  __syncthreads();
  const int half = n >> 1;
  for (int mm = 0; mm < log_n; ++mm) {
    const int m = 1 << mm;
    const int t_log = log_n - mm - 1;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> t_log;
      const int xi = (g << (t_log + 1)) + (i & ((1 << t_log) - 1));
      const int yi = xi + (1 << t_log);
      const uint32_t w = w_tbl[m + g];
      const uint32_t wp = wp_tbl[m + g];
      const uint32_t xs = s[xi];
      const uint32_t ys = s[yi];
      const uint32_t cx = xs >= two_q ? xs - two_q : xs;
      const uint32_t qn = w * ys - __umulhi(ys, wp) * q;
      s[xi] = cx + qn;
      s[yi] = cx + (two_q - qn);
    }
    __syncthreads();
  }
  uint32_t* y = out + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = s[i];
    v = v >= two_q ? v - two_q : v;
    y[i] = v >= q ? v - q : v;
  }
}

__global__ void ntt_inverse_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ tables,
                                   int log_n, uint32_t q0, uint32_t q1) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const long long poly = blockIdx.x;
  const int c = static_cast<int>(poly & 1);
  const uint32_t q = c ? q1 : q0;
  const uint32_t two_q = 2u * q;
  const uint32_t* wi_tbl = tables + static_cast<size_t>(c) * 4 * n + 2 * n;
  const uint32_t* wip_tbl = wi_tbl + n;
  const uint32_t* x = in + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = x[i];
  __syncthreads();
  const int half = n >> 1;
  for (int mm = log_n - 1; mm >= 0; --mm) {
    const int h = 1 << mm;
    const int t_log = log_n - mm - 1;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int g = i >> t_log;
      const int xi = (g << (t_log + 1)) + (i & ((1 << t_log) - 1));
      const int yi = xi + (1 << t_log);
      const uint32_t w = wi_tbl[h + g];
      const uint32_t wp = wip_tbl[h + g];
      const uint32_t xs = s[xi];
      const uint32_t ys = s[yi];
      const uint32_t t_tmp = two_q - ys + xs;
      const uint32_t cx = xs + ys - ((xs << 1) >= t_tmp ? two_q : 0u);
      s[xi] = (cx + q * (t_tmp & 1u)) >> 1;
      s[yi] = w * t_tmp - __umulhi(t_tmp, wp) * q;
    }
    __syncthreads();
  }
  uint32_t* y = out + poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = s[i];
    v = v >= two_q ? v - two_q : v;
    y[i] = v >= q ? v - q : v;
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
    ntt_inverse_kernel<<<static_cast<unsigned>(npolys), kThreads, smem, st>>>(
        x, y, tb, log_n, q0, q1);
  } else {
    ntt_forward_kernel<<<static_cast<unsigned>(npolys), kThreads, smem, st>>>(
        x, y, tb, log_n, q0, q1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sdk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
