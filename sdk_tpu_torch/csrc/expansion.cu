// One coefficient-expansion round for every query of a batch (kernel E),
// fused: for each (query, entry) of the round's work list, the parent
// ciphertext of the previous round, negated by -x^(n-2^r) where flagged, is
// either carried or updated with the query's left or right key:
//   out = base + W (x) G^-1(tau(base) row 0),   row 1 also + tau(base) row 1
// where tau is the round's automorphism x -> x^(n/2^r + 1).
//
// Replaces, on the expansion path, kernels E' (expand_round.cu) and B
// (matmul_mod.cu) with A / A' around them and the torch glue between: the
// round body of sdk_tpu/ops/spiral_jax.py:554 _expansion_round_update as
// driven by coefficient_expansion (:577) and coefficient_expansion_sparse
// (:750, J) -- scalar_mulmod by neg1, from_ntt, automorph_pair, the row-0
// gadget digits, to_ntt_no_reduce, the key matmul_mod, to_ntt of row 1 and
// the two add_mods -- in one launch a round for the whole batch.
//
// A block of 256 threads is two groups of the transform core
// (ntt_device.cuh, sdk::core), one a CRT channel, as kernel F
// (fold_round.cu). Per block, the group of channel c:
//   1. loads its channel of both parent rows, 16 consecutive words a thread
//      (16-byte loads, the core's last layout Lc), and negates them with a
//      Shoup product by neg1 where the entry is flagged; a carried entry is
//      stored as it is and its block is done;
//   2. keeps both rows in shared memory and runs the inverse transform of
//      row 0 (lazy [0, 2q) -> canonical) into its exchange buffer;
//   3. with the other group, CRT-composes row 0 at the automorphism's
//      source coefficients (perm, negation Q - v, so a negated zero is Q)
//      into 2048 uint64 words of shared memory;
//   4. for each of its key digits k: extracts digit k of every coefficient
//      (bits_per wide, 0 once k * bits_per >= 64; reduced when it may reach
//      4q) into the core's first layout, forward-transforms it (outputs
//      lazy < 4q, as to_ntt_no_reduce) and accumulates the Shoup products
//      with the key words W[0, k] and W[1, k] (keys and Shoup companions
//      through the batch's table of per-query pointers), each sum kept
//      below 2q in 32 bits;
//   5. adds the parent, and for row 1 the automorphism of the parent's row
//      1 taken in the NTT domain: tau is a ring automorphism and the NTT
//      evaluates at the roots of x^n + 1, so NTT(tau(a))[k] = NTT(a)[P[k]]
//      (ops/spiral.py ntt_automorph_perms) -- a gather, where the reference
//      runs an inverse and a forward transform of both channels; and stores
//      canonical words to the entry's place in the round's output.
// A round with few updated entries splits each entry's digits over a
// thread block cluster of 2 or 4 blocks (ops/spiral.py expansion_tiling):
// every block of the cluster runs steps 1-3, block `rank` takes digits
// [rank * t_exp / cluster, (rank + 1) * t_exp / cluster), and block 0 adds
// the others' partial sums (< 2q each) through distributed shared memory
// before step 5. The sum mod q is the same number in any grouping.
//
// What bounds it on the H100: at the round sizes of a batch, integer
// instruction issue (2 t_exp + 2 one-channel transforms of 11 x 1024
// Harvey butterflies an updated entry, t_exp 5 at the 1 GiB bucket); in
// the first rounds, with a few blocks on the card, the latency of one
// block's chain of transforms, which the cluster split shortens. A round
// reads and writes 32 KB an entry. The design keeps every intermediate
// (digits, their transforms, the key products) in registers and shared
// memory: nothing but the round's input and output goes through HBM.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sdk::core;

constexpr int kThreads = 2 * kGroup;   // one transform group a CRT channel
constexpr int kCarried = 2;            // the side of an entry kept as it is

// dynamic shared memory: 2 channels x 2 exchange buffers (kPad words), the
// parent's rows [channel][row][kN], then the automorphed row 0 (kN uint64)
constexpr size_t kSmemBytes =
    sizeof(uint32_t) * (4 * kPad + 4 * kN) + sizeof(uint64_t) * kN;

// w * y mod q, lazy in [0, 2q), for w < q, wp = floor(w 2^32 / q), any y
__device__ __forceinline__ uint32_t shoup_mul(uint32_t w, uint32_t wp,
                                              uint32_t y, uint32_t q) {
  return w * y - __umulhi(y, wp) * q;
}

__device__ __forceinline__ void load16(const uint32_t* __restrict__ p,
                                       uint32_t (&v)[kPer]) {
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + h);
    v[4 * h] = u.x; v[4 * h + 1] = u.y; v[4 * h + 2] = u.z; v[4 * h + 3] = u.w;
  }
}

__device__ __forceinline__ void store16(uint32_t* p, const uint32_t (&v)[kPer]) {
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    reinterpret_cast<uint4*>(p)[h] =
        make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
expansion_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 const int4* __restrict__ items, long long n_items,
                 long long n_in, int nq,
                 const unsigned long long* __restrict__ keys,
                 const uint32_t* __restrict__ neg1,
                 const uint32_t* __restrict__ neg1_shoup,
                 const int32_t* __restrict__ perm,
                 const uint8_t* __restrict__ negm,
                 const int32_t* __restrict__ perm_ntt,
                 const uint32_t* __restrict__ tables, int t_exp_l, int bits_l,
                 int t_exp_r, int bits_r, uint64_t Q, uint32_t q0, uint32_t q1,
                 uint64_t inv_q0_mod_q1, int cluster) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = threadIdx.x / kGroup;
  const int j = threadIdx.x % kGroup;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const long long blk = blockIdx.x / cluster;
  const long long query = blk % nq;
  const int4 it = items[blk / nq];       // (out, parent, negate, side)
  const long long ct = 4LL * kN;         // words of a ct: (row, channel, n)
  const uint32_t* par = in + (query * n_in + it.y) * ct;
  uint32_t* dst = out + (query * n_items + it.x) * ct;
  const uint32_t q = c ? q1 : q0;
  uint32_t* buf_a = smem + 2 * c * kPad;           // [channel][buffer]
  uint32_t* buf_b = buf_a + kPad;
  uint32_t* base_s = smem + 4 * kPad;              // [channel][row][kN]
  uint64_t* auto0 = reinterpret_cast<uint64_t*>(smem + 4 * kPad + 4 * kN);

  // 1. the parent's two rows of channel c (Lc), negated where flagged
  uint32_t b[2][kPer];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    load16(par + row * 2 * kN + c * kN + lc_base(j), b[row]);
  }
  if (it.z) {
    uint32_t w[kPer], wp[kPer];
    load16(neg1 + c * kN + lc_base(j), w);
    load16(neg1_shoup + c * kN + lc_base(j), wp);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const uint32_t p = shoup_mul(w[i], wp[i], b[row][i], q);
        b[row][i] = p >= q ? p - q : p;
      }
    }
  }
  if (it.w == kCarried) {
    if (rank == 0) {
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        store16(dst + row * 2 * kN + c * kN + lc_base(j), b[row]);
      }
    }
    return;
  }

  // 2. keep both rows; inverse transform of row 0 into the exchange buffer
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    store16(base_s + (2 * c + row) * kN + lc_base(j), b[row]);
  }
  const uint32_t* tbl = tables + static_cast<size_t>(c) * 4 * kN;
  uint32_t v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = b[0][i];
  inverse(v, buf_a, buf_b, j, 1 + c, tbl, q);
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_canonical(v[i], q);
  to_smem<0>(buf_a, j, v);
  __syncthreads();

  // 3. row 0 composed at the automorphism's sources: tau(a)[x] =
  // +-a[perm[x]], the negation Q - v (0 -> Q)
  {
    const uint64_t mu1 = sdk::barrett_mu(q1);
    const uint32_t* x0s = smem;                    // channel 0's buf_a
    const uint32_t* x1s = smem + 2 * kPad;         // channel 1's buf_a
#pragma unroll 4
    for (int m = 0; m < kN / kThreads; ++m) {
      const int x = threadIdx.x + kThreads * m;
      const int s = pad(__ldg(perm + x));
      const uint64_t val = sdk::crt_compose(x0s[s], x1s[s], q0, q1,
                                            inv_q0_mod_q1, mu1);
      auto0[x] = __ldg(negm + x) ? Q - val : val;
    }
  }
  __syncthreads();

  // 4. this block's key digits: digit -> forward transform -> Shoup
  // products with W[row, k], accumulated below 2q
  const int side = it.w;
  const int t_exp = side ? t_exp_r : t_exp_l;
  const int bits = side ? bits_r : bits_l;
  const unsigned long long* kp = keys + (query * 2 + side) * 2;
  const uint32_t* w_key = reinterpret_cast<const uint32_t*>(kp[0]);
  const uint32_t* w_shoup = reinterpret_cast<const uint32_t*>(kp[1]);
  const int d0 = rank * t_exp / cluster;
  const int d1 = (rank + 1) * t_exp / cluster;
  const uint32_t two_q = 2u * q;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1;
  uint32_t acc[2][kPer];
#pragma unroll
  for (int row = 0; row < 2; ++row)
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[row][i] = 0;
  for (int k = d0; k < d1; ++k) {
    const int off = k * bits;
#pragma unroll
    for (int h = 0; h < kPer / 2; ++h) {
      // coefficients 2j + 256h and 2j + 256h + 1: one 16-byte load
      const ulonglong2 p = reinterpret_cast<const ulonglong2*>(
          auto0 + la_base(j) + la_off(2 * h))[0];
      v[2 * h] = off < 64 ? static_cast<uint32_t>(p.x >> off) & mask : 0u;
      v[2 * h + 1] = off < 64 ? static_cast<uint32_t>(p.y >> off) & mask : 0u;
    }
    if (bits > 29) {                               // digits may reach 4q
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_input(v[i], q);
    }
    forward(v, buf_a, buf_b, j, 1 + c, tbl, q);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const long long off_w =
          (static_cast<long long>(row * t_exp + k) * 2 + c) * kN + lc_base(j);
      const uint4* kw = reinterpret_cast<const uint4*>(w_key + off_w);
      const uint4* ks = reinterpret_cast<const uint4*>(w_shoup + off_w);
#pragma unroll
      for (int h = 0; h < kPer / 4; ++h) {
        const uint4 a = __ldg(kw + h);
        const uint4 s = __ldg(ks + h);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
        const uint32_t sw[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t t = acc[row][4 * h + e] +
                             shoup_mul(aw[e], sw[e], v[4 * h + e], q);
          acc[row][4 * h + e] = min(t, t - two_q);   // < 2q
        }
      }
    }
  }

  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();   // the last transform's reads of buf_b are done
    if (rank != 0) {
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        store16(buf_a + row * kPad + lc_base(j), acc[row]);
      }
    }
    cl.sync();
    if (rank == 0) {
      for (int rk = 1; rk < cluster; ++rk) {
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const uint4* part = reinterpret_cast<const uint4*>(
              cl.map_shared_rank(buf_a + row * kPad, rk) + lc_base(j));
#pragma unroll
          for (int h = 0; h < kPer / 4; ++h) {
            const uint4 p = part[h];
            acc[row][4 * h] += p.x;          // 4 partials < 8q < 2^31
            acc[row][4 * h + 1] += p.y;
            acc[row][4 * h + 2] += p.z;
            acc[row][4 * h + 3] += p.w;
          }
        }
      }
    }
    cl.sync();         // block 0 has read every partial
    if (rank != 0) return;
  }

  // 5. out = base + the key product; row 1 also + the automorphed row 1,
  // gathered in the NTT domain
  const uint32_t* b0 = base_s + (2 * c) * kN;
  const uint32_t* b1 = b0 + kN;
  const int32_t* pn = perm_ntt + c * kN;
  uint32_t o[2][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int x = lc_base(j) + i;
    const uint32_t a0 = acc[0][i] % q;
    const uint32_t a1 = acc[1][i] % q;
    uint32_t s0 = b0[x] + a0;
    s0 = s0 >= q ? s0 - q : s0;
    uint32_t s1 = b1[x] + a1;
    s1 = s1 >= q ? s1 - q : s1;
    s1 += b1[__ldg(pn + x)];
    o[0][i] = s0;
    o[1][i] = s1 >= q ? s1 - q : s1;
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    store16(dst + row * 2 * kN + c * kN + lc_base(j), o[row]);
  }
}

// Lets the kernel use kSmemBytes of dynamic shared memory, once a device.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(expansion_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// in: (nq, n_in, 2, 2, n) uint32 NTT cts of the previous round; out: (nq,
// n_items, 2, 2, n), n = 2048; items: (n_items, 4) int32 (output position,
// parent position, negate, side 0 left / 1 right / 2 carried), one per
// output entry. keys: this round's (nq, 2 sides, 2) pointers to the
// (2, t_exp, 2, n) key words and their Shoup companions. neg1,
// neg1_shoup: (2, n); perm, negm: (n) int32 / bool (a byte, 0 or 1); perm_ntt: (2, n)
// int32; tables: (2, 4, n). cluster: blocks an updated entry (1, 2 or 4).
extern "C" int sdk_expansion(const void* in, void* out, const void* items,
                             long long n_items, long long n_in, int nq,
                             const void* keys, const void* neg1,
                             const void* neg1_shoup, const void* perm,
                             const void* negm, const void* perm_ntt,
                             const void* tables, int t_exp_l, int bits_l,
                             int t_exp_r, int bits_r, unsigned long long Q,
                             unsigned int q0, unsigned int q1,
                             unsigned long long inv_q0_mod_q1, int cluster,
                             void* stream) {
  const long long blocks = n_items * nq * cluster;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  if ((cluster != 1 && cluster != 2 && cluster != 4) || blocks > 0x7FFFFFFFLL ||
      t_exp_l < 1 || t_exp_r < 1 || t_exp_l > 64 || t_exp_r > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, expansion_kernel, static_cast<const uint32_t*>(in),
      static_cast<uint32_t*>(out), static_cast<const int4*>(items), n_items,
      n_in, nq, static_cast<const unsigned long long*>(keys),
      static_cast<const uint32_t*>(neg1),
      static_cast<const uint32_t*>(neg1_shoup),
      static_cast<const int32_t*>(perm), static_cast<const uint8_t*>(negm),
      static_cast<const int32_t*>(perm_ntt),
      static_cast<const uint32_t*>(tables), t_exp_l, bits_l, t_exp_r, bits_r,
      static_cast<uint64_t>(Q), q0, q1, static_cast<uint64_t>(inv_q0_mod_q1),
      cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of E an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// negative on an error.
extern "C" int sdk_expansion_occupancy() {
  int n = 0;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, expansion_kernel, kThreads, kSmemBytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
