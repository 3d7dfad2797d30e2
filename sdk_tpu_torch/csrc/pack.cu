// Ciphertext packing (kernel G), fused: the n*n folded scalar ciphertexts of
// one (query, instance) become one (n+1) x n matrix ciphertext, for every
// query and instance of the batch in one launch.
//
// Replaces sdk_tpu/ops/spiral_jax.py:878 pack (both params.version branches,
// :893-913) and, when a raw output is asked for, the from_ntt that follows it
// in sdk_tpu/ops/server_jax.py:385 _pack_impl. The composed form ran, per
// instance and column, ~12 launches of A, A', B and ~40 elementwise ops; a
// read launched it 8 times, a 16-query batch 128 times.
//
// One block per (query, instance, column c); it loops over r. In dynamic
// shared memory it keeps v_int and prod ((n+1) rows x 2 channels x z words
// each), and two 2-channel work polynomials. Per r, with ct = v_ct[r*n + c]:
//   prod     = 0, then prod[1 (version 1) or 1+r (version 0)] = to_ntt(ct[1])
//   prod    += key (n+1, t_conv) @ to_ntt(digits of ct[0])   one digit a time
//   version 1, r times: raw = from_ntt(prod[0]); prod = [0, rest[-1],
//              rest[:-1]] (rest = prod[1:]) + w_shift @ to_ntt(digits of raw)
//   v_int   += prod
// to_ntt is the reducing path: values mod Q and digits (up to 32 bits) are
// reduced mod q_c before the transform, unlike the fold's digits. Every
// stored residue is canonical: a product is added as (p + w*y) mod q in 64
// bits (Barrett). Each thread owns the same coefficients of every polynomial, so only
// the transforms need barriers. The keys are read through a table of
// per-query pointers (each client's own tensors), so a batch stacks nothing;
// their Shoup companions are not read (the 64-bit product gives the same
// residue). With out_raw the block ends with the inverse NTT of its n+1 rows
// and the CRT compose (the from_ntt of _pack_impl, fused); with out_ntt it
// stores the NTT residues, which is what pack returns.
//
// What bounds it on the H100: latency. A block moves n * 32 KB in and
// (n+1) * 16 KB out and does, at n = 2, t_conv = 3, version 1, 12 forward and
// 2-4 inverse two-channel transforms one after the other (13 barriers each);
// a read has only instances * n = 8 blocks, so the card is never full and the
// time is one block's chain of transforms.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

constexpr int kThreads = 1024;

struct PackArgs {
  const int64_t* v_ct;            // (NQ, inst, n*n, 2, 1, z)
  const uint32_t* const* keys;    // (NQ, nkeys) pointers to (n+1, t_conv, 2, z)
  const uint32_t* tables;
  uint32_t* out_ntt;              // (NQ, inst, n+1, n, 2, z) or null
  int64_t* out_raw;               // (NQ, inst, n+1, n, z) or null
  int instances, n, t_conv, bits_per, version, log_n;
  uint32_t q0, q1;
  uint64_t inv_q0_mod_q1;
};

// prod[row] = (prod[row] + key[row][k] * y) mod q at every coefficient, for
// the 2-channel NTT polynomial y in `work`.
__device__ __forceinline__ void accumulate(uint32_t* prod,
                                           const uint32_t* __restrict__ key,
                                           const uint32_t* work, int rows,
                                           int t_conv, int k, int z,
                                           uint32_t q0, uint32_t q1,
                                           uint64_t mu0, uint64_t mu1) {
  for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
    const int c = idx / z;
    const uint32_t q = c ? q1 : q0;
    const uint64_t mu = c ? mu1 : mu0;
    const uint64_t y = sdk::ntt_canonical(work[idx], q);
    for (int row = 0; row < rows; ++row) {
      const uint64_t w = key[(static_cast<size_t>(row) * t_conv + k) * 2 * z + idx];
      uint32_t* p = prod + static_cast<size_t>(row) * 2 * z + idx;
      *p = sdk::barrett_reduce(*p + w * y, q, mu);
    }
  }
}

__global__ void __launch_bounds__(kThreads) pack_kernel(PackArgs a) {
  extern __shared__ uint32_t smem[];
  const int z = 1 << a.log_n;
  const int n = a.n;
  const int rows = n + 1;
  uint32_t* v_int = smem;                    // (rows, 2, z)
  uint32_t* prod = v_int + rows * 2 * z;     // (rows, 2, z)
  uint32_t* work = prod + rows * 2 * z;      // (2, z)
  uint32_t* work2 = work + 2 * z;            // (2, z)
  const int c_col = blockIdx.x % n;
  const int inst = (blockIdx.x / n) % a.instances;
  const int query = blockIdx.x / (n * a.instances);
  const uint32_t* const* keys =
      a.keys + static_cast<size_t>(query) * (a.version == 0 ? n : 2);
  const uint32_t q0 = a.q0, q1 = a.q1;
  const uint64_t mu0 = sdk::barrett_mu(q0), mu1 = sdk::barrett_mu(q1);

  for (int idx = threadIdx.x; idx < rows * 2 * z; idx += blockDim.x) {
    v_int[idx] = 0;
  }
  for (int r = 0; r < n; ++r) {
    const int64_t* ct =
        a.v_ct + ((static_cast<size_t>(query) * a.instances + inst) * n * n +
                  r * n + c_col) * 2 * z;
    // prod = 0 but for the row that takes to_ntt(ct[1])
    for (int idx = threadIdx.x; idx < rows * 2 * z; idx += blockDim.x) {
      prod[idx] = 0;
    }
    for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
      const int c = idx / z;
      work[idx] = sdk::barrett_reduce(static_cast<uint64_t>(ct[z + idx % z]),
                                      c ? q1 : q0, c ? mu1 : mu0);
    }
    __syncthreads();
    sdk::ntt_forward_smem(work, 2, 0, a.tables, a.log_n, q0, q1);
    uint32_t* ct2_row = prod + (a.version == 0 ? 1 + r : 1) * 2 * z;
    for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
      ct2_row[idx] = sdk::ntt_canonical(work[idx], idx / z ? q1 : q0);
    }
    const uint32_t* key = a.version == 0 ? keys[r] : keys[0];
    for (int k = 0; k < a.t_conv; ++k) {
      __syncthreads();   // work was read by the step before
      for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
        const int c = idx / z;
        const uint32_t d = sdk::gadget_digit(
            static_cast<uint64_t>(ct[idx % z]), k, a.bits_per);
        work[idx] = d % (c ? q1 : q0);
      }
      __syncthreads();
      sdk::ntt_forward_smem(work, 2, 0, a.tables, a.log_n, q0, q1);
      accumulate(prod, key, work, rows, a.t_conv, k, z, q0, q1, mu0, mu1);
    }
    if (a.version != 0) {
      for (int step = 0; step < r; ++step) {
        // work2 = inverse NTT of prod[0]; then roll the rows in place
        for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
          work2[idx] = prod[idx];
          uint32_t carry = prod[(rows - 1) * 2 * z + idx];
          for (int row = rows - 1; row >= 2; --row) {
            prod[row * 2 * z + idx] = prod[(row - 1) * 2 * z + idx];
          }
          prod[2 * z + idx] = carry;
          prod[idx] = 0;
        }
        __syncthreads();
        sdk::ntt_inverse_smem(work2, 2, 0, a.tables, a.log_n, q0, q1);
        for (int k = 0; k < a.t_conv; ++k) {
          __syncthreads();
          for (int idx = threadIdx.x; idx < 2 * z; idx += blockDim.x) {
            const int c = idx / z;
            const int i = idx % z;
            const uint64_t raw = sdk::crt_compose(
                sdk::ntt_canonical(work2[i], q0),
                sdk::ntt_canonical(work2[z + i], q1), q0, q1,
                a.inv_q0_mod_q1, mu1);
            work[idx] = sdk::gadget_digit(raw, k, a.bits_per) % (c ? q1 : q0);
          }
          __syncthreads();
          sdk::ntt_forward_smem(work, 2, 0, a.tables, a.log_n, q0, q1);
          accumulate(prod, keys[1], work, rows, a.t_conv, k, z, q0, q1, mu0,
                     mu1);
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * 2 * z; idx += blockDim.x) {
      const uint32_t q = (idx / z) & 1 ? q1 : q0;
      const uint32_t v = v_int[idx] + prod[idx];
      v_int[idx] = v >= q ? v - q : v;
    }
    __syncthreads();   // work and prod are rewritten by the next r
  }

  const size_t out_row0 = (static_cast<size_t>(query) * a.instances + inst) * rows;
  if (a.out_ntt != nullptr) {
    for (int idx = threadIdx.x; idx < rows * 2 * z; idx += blockDim.x) {
      const int row = idx / (2 * z);
      a.out_ntt[((out_row0 + row) * n + c_col) * 2 * z + idx % (2 * z)] =
          v_int[idx];
    }
  }
  if (a.out_raw != nullptr) {
    __syncthreads();
    sdk::ntt_inverse_smem(v_int, rows * 2, 0, a.tables, a.log_n, q0, q1);
    for (int idx = threadIdx.x; idx < rows * z; idx += blockDim.x) {
      const int row = idx / z;
      const int i = idx % z;
      a.out_raw[((out_row0 + row) * n + c_col) * z + i] = static_cast<int64_t>(
          sdk::crt_compose(sdk::ntt_canonical(v_int[row * 2 * z + i], q0),
                           sdk::ntt_canonical(v_int[row * 2 * z + z + i], q1),
                           q0, q1, a.inv_q0_mod_q1, mu1));
    }
  }
}

}  // namespace

// v_ct: (nq, instances, n*n, 2, 1, z) int64 raw values mod Q. keys: device
// table of nq * nkeys pointers (nkeys = n for version 0: v_packing[r]; 2 for
// version 1: w_key, w_shift), each to a (n+1, t_conv, 2, z) uint32 NTT matrix.
// out_ntt: (nq, instances, n+1, n, 2, z) uint32 or null; out_raw: (nq,
// instances, n+1, n, z) int64 or null. tables: (2, 4, z).
extern "C" int sdk_pack(const void* v_ct, const void* keys, const void* tables,
                        void* out_ntt, void* out_raw, int nq, int instances,
                        int n, int t_conv, int bits_per, int version,
                        int log_n, unsigned int q0, unsigned int q1,
                        unsigned long long inv_q0_mod_q1, void* stream) {
  const long long blocks = static_cast<long long>(nq) * instances * n;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem =
      (static_cast<size_t>(2 * (n + 1) + 2) * 2 * sizeof(uint32_t)) << log_n;
  if (smem > 227 * 1024 || blocks > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  PackArgs a;
  a.v_ct = static_cast<const int64_t*>(v_ct);
  a.keys = static_cast<const uint32_t* const*>(keys);
  a.tables = static_cast<const uint32_t*>(tables);
  a.out_ntt = static_cast<uint32_t*>(out_ntt);
  a.out_raw = static_cast<int64_t*>(out_raw);
  a.instances = instances;
  a.n = n;
  a.t_conv = t_conv;
  a.bits_per = bits_per;
  a.version = version;
  a.log_n = log_n;
  a.q0 = q0;
  a.q1 = q1;
  a.inv_q0_mod_q1 = inv_q0_mod_q1;
  pack_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
