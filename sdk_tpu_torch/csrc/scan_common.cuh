// Shared by the dense (scan.cu) and compact (scan_compact.cu) first-dimension
// scans: the 7-bit limb split and the epilogues that recombine the
// weight-group sums.
//
// A residue v < 2^28 is four 7-bit limbs v = sum_k limb_k * 2^{7k}. Limb
// products are summed by weight s = k + l in int32 (at most
// 4 * 127^2 * terms < 2^31 for terms <= 2^15), and the epilogue forms
// sum_s S_s * (2^{7s} mod q) in a uint64 (< 7 * 2^31 * 2^28) with one
// reduction: recombine_store (scan.cu's scan_kernel) divides by q in 64
// bits, recombine (the compact and resident scans) takes host constants
// and reduces with two Shoup products, 32-bit multiply-highs and no
// division.

#pragma once

#include <cstdint>

namespace scan_common {

constexpr int kLimbs = 4;
constexpr int kWeights = 2 * kLimbs - 1;
constexpr int kRowsPerBlock = 128;
// Epilogue constants a channel: w[s] = 2^{7s} mod q (s < 7), then
// c = 2^32 mod q, floor(2^32 c / q) and floor(2^32 / q).
constexpr int kEpi = kWeights + 3;

// Limb l of v in bits 7l .. 7l + 6.
__device__ __forceinline__ uint32_t limb(uint32_t v, int l) {
  return (v >> (7 * l)) & 127u;
}

// out[rr] = sum_s acc[s][rr] * 2^{7s} mod q, for the RT columns of a thread.
template <int RT>
__device__ __forceinline__ void recombine_store(
    const int32_t (&acc)[kWeights][RT], uint32_t q, uint32_t* o) {
  uint64_t wpow[kWeights];
  wpow[0] = 1;
#pragma unroll
  for (int s = 1; s < kWeights; ++s) wpow[s] = (wpow[s - 1] << 7) % q;
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    uint64_t sum = 0;
#pragma unroll
    for (int s = 0; s < kWeights; ++s)
      sum += static_cast<uint64_t>(static_cast<uint32_t>(acc[s][rr])) * wpow[s];
    o[rr] = static_cast<uint32_t>(sum % q);
  }
}

// Shoup: a * w mod q for a < 2^32, w < q < 2^31, wq = floor(w 2^32 / q).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w,
                                              uint32_t wq, uint32_t q) {
  uint32_t r = a * w - __umulhi(a, wq) * q;  // in [0, 2q)
  return r >= q ? r - q : r;
}

// sum_s acc[s] * w[s] mod q: the sum in 64 bits (< 7 * 2^31 * 2^28), then
// its high word times 2^32 mod q and its low word, each by Shoup; w holds
// the kEpi constants of q.
__device__ __forceinline__ uint32_t recombine(const int32_t (&acc)[kWeights],
                                              const uint32_t* w, uint32_t q) {
  uint64_t x = 0;
#pragma unroll
  for (int s = 0; s < kWeights; ++s)
    x += static_cast<uint64_t>(static_cast<uint32_t>(acc[s])) * w[s];
  const uint32_t hi = mul_shoup(static_cast<uint32_t>(x >> 32), w[kWeights],
                                w[kWeights + 1], q);
  const uint32_t lo = mul_shoup(static_cast<uint32_t>(x), 1u, w[kWeights + 2],
                                q);
  const uint32_t r = hi + lo;
  return r >= q ? r - q : r;
}

}  // namespace scan_common
