// The response encode's arithmetic, shared by encode.cu (kernel D) and
// pack.cu (kernel G, whose out_words mode encodes in the block): the modulus
// switch of a packed value x in [0, Q), Q = q0 * q1, to q2 (row 0 of a
// packed matrix) or to q1 = 4p (rows 1..n).
//
// Replaces sdk_tpu/ops/encode_jax.py:40 rescale_pair (reference semantics
// lib/spiral-rs arith.rs rescale): rescale(x) = floor(N / Q) mod out with
// N = x*out + Q//2, without a 128-bit product or a 57-bit divide. N mod Q
// comes from the two CRT residues (Garner), and since floor(N/Q) < 2^32 and
// Q is odd, floor(N/Q) = low32(N - (N mod Q)) * Q^{-1} mod 2^32 exactly.
// The residues are 32-bit, so every product mod q_c is a Shoup product with
// a precomputed word (three instructions and a subtraction): the compiler's
// 64-bit `%` is a subroutine of more than a hundred instructions, a 64-bit
// Barrett reduction about fifteen.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace sdk {

// Per-launch constants of the encode; field f = 0 is row 0 (q2), f = 1 the
// other rows (q1 = 4p). A "Shoup" word is w' = floor(w 2^32 / q) of a w < q.
struct EncodeConsts {
  uint32_t q0, q1, inv_q0_mod_q1;
  uint32_t inv_shoup;             // of inv_q0_mod_q1 mod q1
  uint32_t m1;                    // floor(2^32 / q1)
  uint32_t qinv;                  // Q^{-1} mod 2^32
  uint64_t mu0, mu1;              // barrett_mu(q0), barrett_mu(q1)
  uint32_t h_lo, h0, h1;          // Q / 2: its low 32 bits, mod q0, mod q1
  uint32_t out_mod[2];            // q2, 4p
  uint32_t out_res[2][2];         // out_mod[f] mod q0, mod q1
  uint32_t out_shoup[2][2];       // their Shoup words
  uint32_t bits[2];               // q2_bits, q1_bits (<= 32)
};

inline uint32_t shoup_word(uint32_t w, uint32_t q) {
  return static_cast<uint32_t>((static_cast<uint64_t>(w) << 32) / q);
}

inline EncodeConsts make_encode_consts(uint32_t q0, uint32_t q1,
                                       uint32_t inv_q0_mod_q1,
                                       unsigned long long modulus,
                                       uint32_t qinv, uint32_t q2_val,
                                       uint32_t q1_val, uint32_t q2_bits,
                                       uint32_t q1_bits) {
  EncodeConsts e;
  e.q0 = q0;
  e.q1 = q1;
  e.inv_q0_mod_q1 = inv_q0_mod_q1;
  e.inv_shoup = shoup_word(inv_q0_mod_q1, q1);
  e.m1 = static_cast<uint32_t>((1ull << 32) / q1);
  e.qinv = qinv;
  e.mu0 = ~0ull / q0;
  e.mu1 = ~0ull / q1;
  const unsigned long long h = modulus / 2;
  e.h_lo = static_cast<uint32_t>(h);
  e.h0 = static_cast<uint32_t>(h % q0);
  e.h1 = static_cast<uint32_t>(h % q1);
  e.out_mod[0] = q2_val;
  e.out_mod[1] = q1_val;
  for (int f = 0; f < 2; ++f) {
    e.out_res[f][0] = e.out_mod[f] % q0;
    e.out_res[f][1] = e.out_mod[f] % q1;
    e.out_shoup[f][0] = shoup_word(e.out_res[f][0], q0);
    e.out_shoup[f][1] = shoup_word(e.out_res[f][1], q1);
  }
  e.bits[0] = q2_bits;
  e.bits[1] = q1_bits;
  return e;
}

// w * y mod q for w < q and its Shoup word ws, any y: w*y - floor(y ws /
// 2^32) q lies in [0, 2q), one subtraction makes it canonical
__device__ __forceinline__ uint32_t mulmod_shoup(uint32_t w, uint32_t ws,
                                                 uint32_t y, uint32_t q) {
  const uint32_t r = w * y - __umulhi(y, ws) * q;
  return r >= q ? r - q : r;
}

// any x < 2^32 mod q, m = floor(2^32 / q): the estimated quotient
// floor(x m / 2^32) is the true one or one less
__device__ __forceinline__ uint32_t reduce32(uint32_t x, uint32_t q,
                                            uint32_t m) {
  const uint32_t r = x - __umulhi(x, m) * q;
  return r >= q ? r - q : r;
}

// Garner: residues x0 < q0, x1 < q1 -> the value in [0, Q) (the same
// number as ntt_device.cuh crt_compose, in 32-bit Shoup arithmetic)
__device__ __forceinline__ uint64_t compose(uint32_t x0, uint32_t x1,
                                            const EncodeConsts& e) {
  uint32_t d = x1 + e.q1 - reduce32(x0, e.q1, e.m1);
  d = d >= e.q1 ? d - e.q1 : d;
  const uint32_t t = mulmod_shoup(e.inv_q0_mod_q1, e.inv_shoup, d, e.q1);
  return x0 + static_cast<uint64_t>(e.q0) * t;
}

// rescale of the value x in [0, Q) given by its residues x0 = x mod q0,
// x1 = x mod q1 and its low 32 bits, to field f: in [0, out_mod[f]).
__device__ __forceinline__ uint32_t rescale(uint32_t x0, uint32_t x1,
                                            uint32_t x_lo, int f,
                                            const EncodeConsts& e) {
  // selects, not indexing: a dynamic index would put e in local memory
  const uint32_t out = f ? e.out_mod[1] : e.out_mod[0];
  // N mod q_c = x_c * (out mod q_c) + (Q/2 mod q_c), mod q_c
  uint32_t v0 = mulmod_shoup(f ? e.out_res[1][0] : e.out_res[0][0],
                             f ? e.out_shoup[1][0] : e.out_shoup[0][0], x0,
                             e.q0) + e.h0;
  v0 = v0 >= e.q0 ? v0 - e.q0 : v0;
  uint32_t v1 = mulmod_shoup(f ? e.out_res[1][1] : e.out_res[0][1],
                             f ? e.out_shoup[1][1] : e.out_shoup[0][1], x1,
                             e.q1) + e.h1;
  v1 = v1 >= e.q1 ? v1 - e.q1 : v1;
  // N mod Q by Garner; only its low 32 bits are needed
  uint32_t d = v1 + e.q1 - reduce32(v0, e.q1, e.m1);
  d = d >= e.q1 ? d - e.q1 : d;
  const uint32_t t = mulmod_shoup(e.inv_q0_mod_q1, e.inv_shoup, d, e.q1);
  const uint32_t n_mod_q_lo = v0 + e.q0 * t;
  const uint32_t low32_n = x_lo * out + e.h_lo;
  const uint32_t r = (low32_n - n_mod_q_lo) * e.qinv;
  return r >= out ? r - out : r;
}

}  // namespace sdk
