// Negacyclic NTT butterflies over polynomials held in shared memory, shared
// by ntt.cu and the fused kernels (fold_round.cu, pack.cu, ingest.cu).
//
// Arithmetic: the Harvey butterflies of the reference (ntt_host.py:20-77)
// with Shoup-scaled twiddles from params.ntt_tables, in wrapping uint32:
// w*y - mulhi(y, w')*q is exact because the true difference is < 2q < 2^30.
// Twiddles are indexed [m : 2m] per stage and the output is in ntt_host
// order; the inverse's halving step (x + q*(t&1)) >> 1 carries the 1/n.
//
// Every function is called by all threads of the block, on `npolys`
// polynomials of n = 2^log_n words laid out back to back in shared memory,
// polynomial p living in CRT channel (chan0 + p) & 1. The caller makes its
// writes to `s` visible (__syncthreads) before the call; each function ends
// with a barrier, so `s` may be read right after it.
//
// tables: (2, 4, n) uint32 = per channel (w, w', w_inv, w_inv').

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sdk {

// Any uint32 -> a valid forward-NTT input (< 4q): the lazy butterflies take
// [0, 4q), everything above is reduced mod q first.
__device__ __forceinline__ uint32_t ntt_input(uint32_t v, uint32_t q) {
  if (v >= 4u * q) v %= q;   // rare: a branch, not a select over a division
  return v;
}

// A lazy value in [0, 4q) -> its canonical residue in [0, q).
__device__ __forceinline__ uint32_t ntt_canonical(uint32_t v, uint32_t q) {
  const uint32_t two_q = 2u * q;
  v = v >= two_q ? v - two_q : v;
  return v >= q ? v - q : v;
}

// Forward transform in place. Inputs < 4q; outputs lazy in [0, 4q)
// (ntt_canonical makes them canonical).
__device__ __forceinline__ void ntt_forward_smem(uint32_t* s, int npolys,
                                                 int chan0,
                                                 const uint32_t* __restrict__ tables,
                                                 int log_n, uint32_t q0,
                                                 uint32_t q1) {
  const int n = 1 << log_n;
  const int half = n >> 1;
  for (int mm = 0; mm < log_n; ++mm) {
    const int m = 1 << mm;
    const int t_log = log_n - mm - 1;
    for (int p = 0; p < npolys; ++p) {
      const int c = (chan0 + p) & 1;
      const uint32_t q = c ? q1 : q0;
      const uint32_t two_q = 2u * q;
      const uint32_t* w_tbl = tables + static_cast<size_t>(c) * 4 * n;
      const uint32_t* wp_tbl = w_tbl + n;
      uint32_t* sp = s + (static_cast<size_t>(p) << log_n);
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int g = i >> t_log;
        const int xi = (g << (t_log + 1)) + (i & ((1 << t_log) - 1));
        const int yi = xi + (1 << t_log);
        const uint32_t w = w_tbl[m + g];
        const uint32_t wp = wp_tbl[m + g];
        const uint32_t xs = sp[xi];
        const uint32_t ys = sp[yi];
        const uint32_t cx = xs >= two_q ? xs - two_q : xs;
        const uint32_t qn = w * ys - __umulhi(ys, wp) * q;
        sp[xi] = cx + qn;
        sp[yi] = cx + (two_q - qn);
      }
    }
    __syncthreads();
  }
}

// Inverse transform in place. Inputs < 2q; outputs lazy in [0, 2q)
// (ntt_canonical makes them canonical).
__device__ __forceinline__ void ntt_inverse_smem(uint32_t* s, int npolys,
                                                 int chan0,
                                                 const uint32_t* __restrict__ tables,
                                                 int log_n, uint32_t q0,
                                                 uint32_t q1) {
  const int n = 1 << log_n;
  const int half = n >> 1;
  for (int mm = log_n - 1; mm >= 0; --mm) {
    const int h = 1 << mm;
    const int t_log = log_n - mm - 1;
    for (int p = 0; p < npolys; ++p) {
      const int c = (chan0 + p) & 1;
      const uint32_t q = c ? q1 : q0;
      const uint32_t two_q = 2u * q;
      const uint32_t* wi_tbl = tables + static_cast<size_t>(c) * 4 * n + 2 * n;
      const uint32_t* wip_tbl = wi_tbl + n;
      uint32_t* sp = s + (static_cast<size_t>(p) << log_n);
      for (int i = threadIdx.x; i < half; i += blockDim.x) {
        const int g = i >> t_log;
        const int xi = (g << (t_log + 1)) + (i & ((1 << t_log) - 1));
        const int yi = xi + (1 << t_log);
        const uint32_t w = wi_tbl[h + g];
        const uint32_t wp = wip_tbl[h + g];
        const uint32_t xs = sp[xi];
        const uint32_t ys = sp[yi];
        const uint32_t t_tmp = two_q - ys + xs;
        const uint32_t cx = xs + ys - ((xs << 1) >= t_tmp ? two_q : 0u);
        sp[xi] = (cx + q * (t_tmp & 1u)) >> 1;
        sp[yi] = w * t_tmp - __umulhi(t_tmp, wp) * q;
      }
    }
    __syncthreads();
  }
}

// Barrett reduction of any 64-bit x mod q (q < 2^31, not a power of two)
// with mu = floor((2^64 - 1) / q) = floor(2^64 / q): the estimated quotient
// umul64hi(x, mu) is the true one or one less, so x - quot*q lies in
// [0, 2q). A dozen instructions where the compiler's 64-bit `%` is a
// subroutine of more than a hundred.
__device__ __forceinline__ uint64_t barrett_mu(uint32_t q) {
  return ~0ull / q;
}

__device__ __forceinline__ uint32_t barrett_reduce(uint64_t x, uint32_t q,
                                                   uint64_t mu) {
  const uint64_t r = x - __umul64hi(x, mu) * q;
  return static_cast<uint32_t>(r >= q ? r - q : r);
}

// Garner: residues (x0 mod q0, x1 mod q1) -> the value in [0, q0*q1)
// (params.crt_compose_2); mu1 = barrett_mu(q1).
__device__ __forceinline__ uint64_t crt_compose(uint32_t x0, uint32_t x1,
                                                uint32_t q0, uint32_t q1,
                                                uint64_t inv_q0_mod_q1,
                                                uint64_t mu1) {
  const uint32_t d = barrett_reduce(x1 + q1 - barrett_reduce(x0, q1, mu1), q1,
                                    mu1);
  const uint64_t t = barrett_reduce(d * inv_q0_mod_q1, q1, mu1);
  return x0 + static_cast<uint64_t>(q0) * t;
}

// Digit k of the base-2^bits_per decomposition of v (gadget_digits): zero
// once the offset passes 64 bits, at most 32 bits wide.
__device__ __forceinline__ uint32_t gadget_digit(uint64_t v, int k,
                                                 int bits_per) {
  const int off = k * bits_per;
  const uint64_t mask = bits_per >= 32 ? 0xFFFFFFFFull
                                       : (1ull << bits_per) - 1;
  return off >= 64 ? 0u : static_cast<uint32_t>((v >> off) & mask);
}

}  // namespace sdk
