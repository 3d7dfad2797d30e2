// Response encode: modulus switch of the packed ciphertext from Q = q0*q1 to
// q2 (row 0) and q1 = 4p (the other rows), then an LSB-first bit-pack into
// little-endian uint32 words. The words' bytes are the wire response.
//
// Replaces: sdk_tpu/ops/encode_jax.py:99 ResponseEncodePlan.encode and
// :40 rescale_pair (reference semantics lib/spiral-rs arith.rs rescale and
// util.rs write_arbitrary_bits).
//
// Rescale without a 128-bit product or a 57-bit divide, as the JAX build:
// rescale(x) = floor(N / Q) mod out with N = x*out + Q//2. N mod Q comes
// from the two CRT residues (Garner), and since floor(N/Q) < 2^32 and Q is
// odd, floor(N/Q) = low32(N - (N mod Q)) * Q^{-1} mod 2^32 exactly.
//
// What bounds it on the H100: launch and latency. The 1 GiB bucket's
// response is 21504 words from 49152 values (0.4 MB read, 86 KB written), a
// few microseconds of work. The design: one thread per output word; the
// thread walks the fields that overlap its 32 bits (22- and 10-bit fields
// straddle word boundaries), rescales each value it needs on the fly and
// writes its word once, so there is no scatter, no atomics and no second
// pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct EncodeArgs {
  unsigned long long num_bits;   // meaningful bits; the rest is zero padding
  unsigned long long inst_bits;  // bits per instance
  unsigned long long seg0_bits;  // bits of row 0 within an instance
  unsigned long long inst_vals;  // values per instance: (n+1) * n * Z
  unsigned long long seg0_vals;  // values of row 0: n * Z
  unsigned long long h;          // Q / 2
  uint32_t q2_bits, q1_bits, q2_val, q1_val;
  uint32_t q0, q1, inv_q0_mod_q1, qinv;  // qinv = Q^{-1} mod 2^32
};

__device__ uint32_t rescale(uint64_t x, uint32_t out_mod, const EncodeArgs& a) {
  const uint64_t q0 = a.q0, q1 = a.q1;
  const uint64_t v0 = ((x % q0) * (out_mod % q0) + a.h % q0) % q0;
  const uint64_t v1 = ((x % q1) * (out_mod % q1) + a.h % q1) % q1;
  const uint64_t d = (v1 + q1 - v0 % q1) % q1;
  const uint64_t t = (d * a.inv_q0_mod_q1) % q1;
  const uint32_t n_mod_q_lo = static_cast<uint32_t>(v0 + q0 * t);
  const uint32_t low32_n =
      static_cast<uint32_t>(x) * out_mod + static_cast<uint32_t>(a.h);
  const uint32_t r = (low32_n - n_mod_q_lo) * a.qinv;
  return r >= out_mod ? r - out_mod : r;
}

__global__ void encode_kernel(const uint64_t* __restrict__ vals,
                              uint32_t* __restrict__ words, long long nwords,
                              EncodeArgs a) {
  const long long w =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= nwords) return;
  unsigned long long p = static_cast<unsigned long long>(w) * 32;
  uint32_t word = 0;
  uint32_t filled = 0;
  while (filled < 32 && p < a.num_bits) {
    const unsigned long long inst = p / a.inst_bits;
    unsigned long long rem = p % a.inst_bits;
    unsigned long long off = inst * a.inst_vals;
    uint32_t width, bo, out_mod;
    if (rem < a.seg0_bits) {
      width = a.q2_bits;
      out_mod = a.q2_val;
      off += rem / width;
      bo = static_cast<uint32_t>(rem % width);
    } else {
      rem -= a.seg0_bits;
      width = a.q1_bits;
      out_mod = a.q1_val;
      off += a.seg0_vals + rem / width;
      bo = static_cast<uint32_t>(rem % width);
    }
    const uint32_t v = rescale(vals[off], out_mod, a);
    const uint32_t take = min(width - bo, 32u - filled);
    const uint32_t mask = take == 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
    word |= ((v >> bo) & mask) << filled;
    filled += take;
    p += take;
  }
  words[w] = word;
}

}  // namespace

// vals: (instances, n+1, n, Z) uint64 values in [0, Q); words: nwords uint32.
extern "C" int sdk_encode(const void* vals, void* words, long long nwords,
                          int n, int Z, int instances, unsigned int q2_bits,
                          unsigned int q1_bits, unsigned int q2_val,
                          unsigned int q1_val, unsigned int q0,
                          unsigned int q1, unsigned int inv_q0_mod_q1,
                          unsigned long long modulus, unsigned int qinv,
                          void* stream) {
  EncodeArgs a;
  a.seg0_bits = 1ULL * n * Z * q2_bits;
  a.inst_bits = a.seg0_bits + 1ULL * n * n * Z * q1_bits;
  a.num_bits = a.inst_bits * instances;
  a.inst_vals = 1ULL * (n + 1) * n * Z;
  a.seg0_vals = 1ULL * n * Z;
  a.h = modulus / 2;
  a.q2_bits = q2_bits;
  a.q1_bits = q1_bits;
  a.q2_val = q2_val;
  a.q1_val = q1_val;
  a.q0 = q0;
  a.q1 = q1;
  a.inv_q0_mod_q1 = inv_q0_mod_q1;
  a.qinv = qinv;
  if (nwords <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (nwords + kThreads - 1) / kThreads;
  encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(vals), static_cast<uint32_t*>(words),
      nwords, a);
  return static_cast<int>(cudaGetLastError());
}
