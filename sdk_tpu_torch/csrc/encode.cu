// Response encode: modulus switch of the packed ciphertext from Q = q0*q1 to
// q2 (row 0) and q1 = 4p (the other rows), then an LSB-first bit-pack into
// little-endian uint32 words. The words' bytes are the wire response.
//
// Replaces: sdk_tpu/ops/encode_jax.py:99 ResponseEncodePlan.encode and
// :40 rescale_pair (reference semantics lib/spiral-rs arith.rs rescale and
// util.rs write_arbitrary_bits). The rescale's arithmetic lives in
// encode_device.cuh, which kernel G (pack.cu) shares: since G encodes in its
// out_words mode, no read launches D; D stays the standalone counterpart of
// encode_jax.py:99.
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

#include "encode_device.cuh"

namespace {

constexpr int kThreads = 256;

struct EncodeArgs {
  unsigned long long num_bits;   // meaningful bits; the rest is zero padding
  unsigned long long inst_bits;  // bits per instance
  unsigned long long seg0_bits;  // bits of row 0 within an instance
  unsigned long long inst_vals;  // values per instance: (n+1) * n * Z
  unsigned long long seg0_vals;  // values of row 0: n * Z
  sdk::EncodeConsts e;
};

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
    int f = 0;
    if (rem >= a.seg0_bits) {
      rem -= a.seg0_bits;
      off += a.seg0_vals;
      f = 1;
    }
    const uint32_t width = f ? a.e.bits[1] : a.e.bits[0];
    off += rem / width;
    const uint32_t bo = static_cast<uint32_t>(rem % width);
    const uint64_t x = vals[off];
    const uint32_t v = sdk::rescale(
        sdk::barrett_reduce(x, a.e.q0, a.e.mu0),
        sdk::barrett_reduce(x, a.e.q1, a.e.mu1), static_cast<uint32_t>(x), f,
        a.e);
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
  a.e = sdk::make_encode_consts(q0, q1, inv_q0_mod_q1, modulus, qinv, q2_val,
                                q1_val, q2_bits, q1_bits);
  if (nwords <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (nwords + kThreads - 1) / kThreads;
  encode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(vals), static_cast<uint32_t*>(words),
      nwords, a);
  return static_cast<int>(cudaGetLastError());
}
