// One GSW fold round (kernel F), fused: for every output slot of every query
// of the batch, out = V_neg (x) a + V_fold (x) b with the all-zero shortcut.
//
// Replaces the round body of sdk_tpu/ops/spiral_jax.py:818 fold_ciphertexts
// (:849-874; batched use sdk_tpu/ops/server_jax.py:565-603): gadget_digits of
// a and b, to_ntt_no_reduce, the [V_neg | V_fold] @ [G(a); G(b)] matmul_mod
// with k = 4*t_gsw, from_ntt (inverse NTT + CRT compose) and the za/zb
// select. The composed form launched A, B and A' plus ~20 elementwise ops a
// round and wrote the round's 2*ell digit polynomials per slot to device
// memory three times (int64 digits, int32 NTT input, int32 NTT output).
//
// One block per output slot s of batch entry e (a = input slot s, b = input
// slot s + num_per). Each thread owns coefficients tid + j*kThreads (j < 4)
// of every polynomial: it keeps the raw a and b values (2 rows each) and the
// 2 rows x 2 channels of 64-bit accumulators in registers. While loading it
// ORs the values, and one block-wide vote gives za / zb; a slot with a == 0
// returns b verbatim, one with b == 0 returns a verbatim (fold.rs:37-44), and
// in both cases the block does no arithmetic at all (the JAX program
// computes the product and then discards it, for want of dynamic shapes).
// Otherwise, for digit k of a (then of b): extract it from both rows, write
// it unreduced into both channels of a 32 KB shared-memory buffer (four
// polynomials: row x channel), forward-NTT the four together
// (ntt_device.cuh: one pass of barriers for two digit polynomials), and
// multiply-accumulate the lazy outputs (< 4q < 2^30) with the two key rows
// as exact 64-bit products (4*t_gsw * 2^58 < 2^64 for t_gsw <= 15). The four
// accumulators are reduced mod q once (Barrett; canonical, as matmul_mod
// leaves them), inverse-NTT'd together in the same buffer, CRT-composed and
// stored. The
// keys' Shoup companions are not read: the 64-bit product is one IMAD.WIDE on
// this card and halves the key bytes; the sum mod q is the same number.
//
// What bounds it on the H100: integer operations. A slot moves 64 KB in and
// 32 KB out (the keys, 2*2*ell*16 KB a query and round, stay in L2 across
// the slots that share them) against 2*ell + 2 two-channel transforms of
// 11 * 1024 butterflies (~10 integer instructions each) and 2*ell*8192
// multiply-adds, about 80 integer operations per byte moved; the shared-
// memory butterflies and their 13 barriers a transform are what the time
// goes to.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 4;   // coefficients a thread owns: n <= kThreads * kPer

__global__ void __launch_bounds__(kThreads)
fold_round_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  const uint32_t* __restrict__ v_neg,
                  const uint32_t* __restrict__ v_fold,
                  const uint32_t* __restrict__ tables, long long num_per,
                  long long rep, long long key_stride, int t_gsw,
                  int bits_per, int log_n, uint32_t q0, uint32_t q1,
                  uint64_t inv_q0_mod_q1) {
  __shared__ uint32_t s[4 * kThreads * kPer];   // 4 polynomials, 32 KB
  const int n = 1 << log_n;
  const int tid = threadIdx.x;
  const long long slot = blockIdx.x % num_per;
  const long long entry = blockIdx.x / num_per;   // flat (query, it) index
  const long long ct = 2LL * n;                   // words of one ct (2, 1, n)
  const int64_t* a_ptr = in + (entry * 2 * num_per + slot) * ct;
  const int64_t* b_ptr = a_ptr + num_per * ct;
  int64_t* o_ptr = out + (entry * num_per + slot) * ct;

  // raw[which][row][j]: which = 0 for a, 1 for b
  uint64_t raw[2][2][kPer];
  int nz_a = 0, nz_b = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      const uint64_t va = i < n ? static_cast<uint64_t>(a_ptr[r * n + i]) : 0;
      const uint64_t vb = i < n ? static_cast<uint64_t>(b_ptr[r * n + i]) : 0;
      raw[0][r][j] = va;
      raw[1][r][j] = vb;
      nz_a |= va != 0;
      nz_b |= vb != 0;
    }
  }
  const bool za = !__syncthreads_or(nz_a);
  const bool zb = !__syncthreads_or(nz_b);
  if (za || zb) {
    // za first: a == 0 takes b (also when both are zero)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < n) {
          o_ptr[r * n + i] =
              static_cast<int64_t>(za ? raw[1][r][j] : raw[0][r][j]);
        }
      }
    }
    return;
  }

  // key rows of this entry's query: (2 rows, ell, 2 channels, n)
  const int ell = 2 * t_gsw;
  const long long query = entry / rep;
  const uint32_t* keys[2] = {v_neg + query * key_stride,
                             v_fold + query * key_stride};
  uint64_t acc[2][2][kPer];   // [row][channel][j]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[r][c][j] = 0;

  const uint64_t mu0 = sdk::barrett_mu(q0);
  const uint64_t mu1 = sdk::barrett_mu(q1);
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    for (int k = 0; k < t_gsw; ++k) {
      // digit k of both rows at once: polynomials (row, channel) of the
      // buffer, so one pass of barriers transforms four of them
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          if (i < n) {
            const uint32_t d = sdk::gadget_digit(raw[which][r][j], k, bits_per);
            s[(2 * r) * n + i] = sdk::ntt_input(d, q0);
            s[(2 * r + 1) * n + i] = sdk::ntt_input(d, q1);
          }
        }
      }
      __syncthreads();
      sdk::ntt_forward_smem(s, 4, 0, tables, log_n, q0, q1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // key column 2*k + r is digit k of row r (gadget_digits)
        const uint32_t* key =
            keys[which] + static_cast<long long>(2 * k + r) * 2 * n;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int i = tid + j * kThreads;
          if (i < n) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint64_t y = s[(2 * r + c) * n + i];
#pragma unroll
              for (int row = 0; row < 2; ++row) {
                acc[row][c][j] +=
                    y * key[(static_cast<long long>(row) * ell * 2 + c) * n + i];
              }
            }
          }
        }
      }
      __syncthreads();   // the buffer is rewritten by the next digit
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = tid + j * kThreads;
        if (i < n) {
          s[(row * 2 + c) * n + i] = sdk::barrett_reduce(
              acc[row][c][j], c ? q1 : q0, c ? mu1 : mu0);
        }
      }
  __syncthreads();
  sdk::ntt_inverse_smem(s, 4, 0, tables, log_n, q0, q1);
#pragma unroll
  for (int row = 0; row < 2; ++row)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n) {
        const uint32_t x0 = sdk::ntt_canonical(s[(row * 2) * n + i], q0);
        const uint32_t x1 = sdk::ntt_canonical(s[(row * 2 + 1) * n + i], q1);
        o_ptr[row * n + i] = static_cast<int64_t>(
            sdk::crt_compose(x0, x1, q0, q1, inv_q0_mod_q1, mu1));
      }
    }
}

}  // namespace

// in: (entries, 2*num_per, 2, 1, n) int64 raw values mod Q; out: (entries,
// num_per, 2, 1, n) int64. v_neg, v_fold: this round's key matrices, (2,
// 2*t_gsw, 2, n) uint32 each, one per query at a distance of key_stride
// words (0: one key for all); entry e uses query e / rep. tables: (2, 4, n).
extern "C" int sdk_fold_round(const void* in, void* out, const void* v_neg,
                              const void* v_fold, const void* tables,
                              long long entries, long long num_per,
                              long long rep, long long key_stride, int t_gsw,
                              int bits_per, int log_n, unsigned int q0,
                              unsigned int q1,
                              unsigned long long inv_q0_mod_q1, void* stream) {
  const long long blocks = entries * num_per;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  if ((1 << log_n) > kThreads * kPer || t_gsw > 15 ||
      blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fold_round_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<int64_t*>(out),
      static_cast<const uint32_t*>(v_neg), static_cast<const uint32_t*>(v_fold),
      static_cast<const uint32_t*>(tables), num_per, rep, key_stride, t_gsw,
      bits_per, log_n, q0, q1, inv_q0_mod_q1);
  return static_cast<int>(cudaGetLastError());
}
