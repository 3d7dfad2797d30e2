// The elementwise body of one coefficient-expansion round (E'), between the
// inverse NTT of the selected ciphertexts and the forward NTT of what the
// key product needs.
//
// Replaces the glue of sdk_tpu/ops/spiral_jax.py:554 _expansion_round_update
// (used by coefficient_expansion :577 and coefficient_expansion_sparse :750):
// CRT compose (from_ntt), automorph_pair :195, gadget_digits :205 on row 0,
// the per-channel reduction of row 1 (to_ntt), and the copy of the digits
// into every channel (to_ntt_no_reduce). The NTTs (ntt.cu) and the key
// product (matmul_mod.cu) stay separate launches.
//
// For each selected ciphertext b, row, and coefficient i:
//   v   = CRT(x[b, row, 0, perm[i]], x[b, row, 1, perm[i]])   (mod Q)
//   v   = neg[i] ? Q - v : v                                  (0 -> Q)
//   row 0: digit k = (v >> k*bits_per) & mask, 0 once k*bits_per >= 64,
//          written to both channels of polynomial (b, k)
//   row 1: v mod q_c for each channel c
// Output: (B * t_exp + B, 2, n) uint32, the B * t_exp digit polynomials
// (b major, k minor) followed by the B row-1 polynomials, ready for one
// forward NTT launch.
//
// What bounds it on the H100: bytes (launch latency at B = 1). It reads 2 * 2
// words per coefficient pair and writes (t_exp + 1) * 2, with a 64-bit
// multiply and two 64-bit remainders per element; one thread per (b, row, i)
// and coalesced writes, the gathered reads hit the same 16 KB polynomial.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void expand_round_kernel(const uint32_t* __restrict__ in,
                                    const int32_t* __restrict__ perm,
                                    const uint8_t* __restrict__ neg,
                                    uint32_t* __restrict__ out, long long B,
                                    int log_n, int t_exp, int bits_per,
                                    uint64_t Q, uint32_t q0, uint32_t q1,
                                    uint64_t inv_q0_mod_q1) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int n = 1 << log_n;
  if (idx >= B * 2 * n) return;
  const int i = static_cast<int>(idx & (n - 1));
  const int row = static_cast<int>((idx >> log_n) & 1);
  const long long b = idx >> (log_n + 1);

  const uint32_t* x = in + ((b * 2 + row) * 2) * n;  // (channel, n)
  const int src = perm[i];
  const uint32_t x0 = x[src];
  const uint32_t x1 = x[n + src];
  const uint64_t t = (static_cast<uint64_t>(x1 + q1 - x0 % q1) % q1) *
                     inv_q0_mod_q1 % q1;
  uint64_t v = x0 + static_cast<uint64_t>(q0) * t;
  if (neg[i]) v = Q - v;

  if (row == 0) {
    const uint64_t mask = bits_per >= 32 ? 0xFFFFFFFFull
                                         : (1ull << bits_per) - 1;
    for (int k = 0; k < t_exp; ++k) {
      const int off = k * bits_per;
      const uint32_t digit =
          off >= 64 ? 0u : static_cast<uint32_t>((v >> off) & mask);
      uint32_t* o = out + ((b * t_exp + k) * 2) * n + i;
      o[0] = digit;
      o[n] = digit;
    }
  } else {
    uint32_t* o = out + ((B * t_exp + b) * 2) * n + i;
    o[0] = static_cast<uint32_t>(v % q0);
    o[n] = static_cast<uint32_t>(v % q1);
  }
}

}  // namespace

// in: (B, 2, 2, n) uint32 residues (ct, row, channel, coefficient); perm:
// (n) int32; neg: (n) uint8; out: (B * t_exp + B, 2, n) uint32.
extern "C" int sdk_expand_round(const void* in, const void* perm,
                                const void* neg, void* out, long long B,
                                int log_n, int t_exp, int bits_per,
                                unsigned long long Q, unsigned int q0,
                                unsigned int q1,
                                unsigned long long inv_q0_mod_q1,
                                void* stream) {
  const long long total = B * 2LL << log_n;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (total + kThreads - 1) / kThreads;
  expand_round_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const int32_t*>(perm),
      static_cast<const uint8_t*>(neg), static_cast<uint32_t*>(out), B, log_n,
      t_exp, bits_per, Q, q0, q1, inv_q0_mod_q1);
  return static_cast<int>(cudaGetLastError());
}
