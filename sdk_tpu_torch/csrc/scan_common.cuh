// Shared by the dense (scan.cu) and compact (scan_compact.cu) first-dimension
// scans: the 7-bit limb split and the epilogue that recombines the
// weight-group sums.
//
// A residue v < 2^28 is four 7-bit limbs v = sum_k limb_k * 2^{7k}. Limb
// products are summed by weight s = k + l in int32 (at most
// 4 * 127^2 * terms < 2^31 for terms <= 2^15), and the epilogue forms
// sum_s S_s * (2^{7s} mod q) in a uint64 (< 7 * 2^26 * 2^28) with one
// reduction.

#pragma once

#include <cstdint>

namespace scan_common {

constexpr int kLimbs = 4;
constexpr int kWeights = 2 * kLimbs - 1;
constexpr int kRowsPerBlock = 128;

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

}  // namespace scan_common
