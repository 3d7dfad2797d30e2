// One GSW fold round (kernel F), fused: for every output slot of every query
// of the batch, out = V_neg (x) a + V_fold (x) b with the all-zero shortcut.
//
// Replaces the round body of sdk_tpu/ops/spiral_jax.py:818 fold_ciphertexts
// (:849-874; batched use sdk_tpu/ops/server_jax.py:565-603): gadget_digits of
// a and b, to_ntt_no_reduce, the [V_neg | V_fold] @ [G(a); G(b)] matmul_mod
// with k = 4*t_gsw, from_ntt (inverse NTT + CRT compose) and the za/zb
// select, in one launch a round.
//
// A slot (a = input slot s, b = input slot s + num_per of batch entry e) is
// 4*t_gsw digit polynomials (which of a / b, row r, digit k), each forward-
// transformed in both CRT channels and multiplied into the two rows of the
// accumulator with the key columns, then one reduction mod q_c, the inverse
// transform of each row and channel, and the CRT compose. A block of 256
// threads is two groups of the transform core (ntt_device.cuh, sdk::core),
// one a channel: the group of channel c extracts the digits of a raw row
// straight into the core's first layout (16-byte loads of int64 pairs),
// transforms them (two barriers), and multiply-adds the lazy outputs (<
// 4q < 2^30) with the key row as exact 64-bit products (4*t_gsw * 2^58 <
// 2^64 for t_gsw <= 15) into accumulators held in registers, the 16
// coefficients a thread owns after the transform, whose key words it reads
// with 16-byte loads. The keys' Shoup companions are not read: the 64-bit
// product is one IMAD.WIDE and the sum mod q is the same number.
//
// Before any arithmetic the block reads all of a and b once and votes: a
// slot with a == 0 returns b verbatim, one with b == 0 returns a verbatim
// (fold.rs:37-44), and both zero stay zero; such a block does no
// arithmetic (the JAX program computes the product and then discards it).
//
// A round with few slots splits each slot over a thread block cluster of
// `cluster` blocks (2 or 4): block `rank` takes digit polynomials [rank *
// D / cluster, (rank + 1) * D / cluster), reduces its partial sums mod q
// and leaves them in its shared memory; after a cluster barrier block 0
// adds them through distributed shared memory (a sum of canonical residues
// is < 4q < 2^31), reduces, inverse-transforms and composes. The sum mod q
// is the same number in any grouping, so every tiling stores the same
// words. The cluster size comes from ops/spiral.py:fold_tiling.
//
// What bounds it on the H100: integer instruction issue. A slot moves 64 KB
// in and 32 KB out (the keys, 2*2*ell*16 KB a query and round, stay in L2
// across the slots that share them) against 4*t_gsw + 2 two-channel
// transforms of 11 x 1024 butterflies and 4*t_gsw * 8192 multiply-adds: a
// thread runs ~1,070 SASS instructions a digit polynomial, 88 butterflies
// of six (three of them IMADs, which issue at half rate), so the FMA pipe's
// IMADs, not HBM, are the floor. A block barrier a stage, twiddles read from
// global memory a butterfly, or one slot an SM would leave it latency-bound
// instead: so a transform has two barriers of its group (each channel's
// group its own named barrier), a stage's twiddles come in one or two
// vector loads from a copy of the forward tables in shared memory, and two
// slots run an SM at 128 registers a thread (the 64 accumulator registers
// decide it: three an SM spill 344 bytes and run 35% slower). Rounds with
// fewer slots than the card has room for take a cluster of 2 or 4 blocks a
// slot, one block a slot from 128 slots up (PERF.md, tools/scan_bench_gpu.py
// --kernel fold --sweep).

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sdk::core;

constexpr int kThreads = 2 * kGroup;   // one transform group a CRT channel

// dynamic shared memory: 2 channels x 2 exchange buffers, then the forward
// twiddles (w | w') of both channels
constexpr size_t kSmemBytes = sizeof(uint32_t) * (4 * kPad + 4 * kN);

__global__ void __launch_bounds__(kThreads, 2)
fold_round_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                  const uint32_t* __restrict__ v_neg,
                  const uint32_t* __restrict__ v_fold,
                  const uint32_t* __restrict__ tables, long long num_per,
                  long long rep, long long key_stride, int t_gsw,
                  int bits_per, uint32_t q0, uint32_t q1,
                  uint64_t inv_q0_mod_q1, int cluster) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = threadIdx.x / kGroup;
  const int j = threadIdx.x % kGroup;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const long long blk = blockIdx.x / cluster;
  const long long slot = blk % num_per;
  const long long entry = blk / num_per;          // flat (query, it) index
  const long long ct = 2LL * kN;                  // words of one ct (2, 1, n)
  const int64_t* a_ptr = in + (entry * 2 * num_per + slot) * ct;
  const int64_t* b_ptr = a_ptr + num_per * ct;
  int64_t* o_ptr = out + (entry * num_per + slot) * ct;

  // the zero vote: every thread reads 1/256 of a and of b
  longlong2 ra[8], rb[8];
  int nz_a = 0, nz_b = 0;
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    ra[h] = reinterpret_cast<const longlong2*>(a_ptr)[threadIdx.x + kThreads * h];
    rb[h] = reinterpret_cast<const longlong2*>(b_ptr)[threadIdx.x + kThreads * h];
    nz_a |= (ra[h].x | ra[h].y) != 0;
    nz_b |= (rb[h].x | rb[h].y) != 0;
  }
  const bool za = !__syncthreads_or(nz_a);
  const bool zb = !__syncthreads_or(nz_b);
  if (za || zb) {
    // za first: a == 0 takes b (also when both are zero)
    if (rank == 0) {
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        reinterpret_cast<longlong2*>(o_ptr)[threadIdx.x + kThreads * h] =
            za ? rb[h] : ra[h];
      }
    }
    return;
  }

  const int ell = 2 * t_gsw;
  const int n_digits = 2 * ell;                   // (which, r, k)
  const int d0 = rank * n_digits / cluster;
  const int d1 = (rank + 1) * n_digits / cluster;
  const uint32_t q = c ? q1 : q0;
  const uint32_t* tbl = tables + static_cast<size_t>(c) * 4 * kN;
  const long long query = entry / rep;
  uint32_t* buf_a = smem + 2 * c * kPad;          // [channel][buffer]
  uint32_t* buf_b = buf_a + kPad;
  // (w | w') of both channels, 2 x 4096 words, into shared memory: the
  // slot's 4*t_gsw forward transforms read their twiddles from there
  uint4* tw_s = reinterpret_cast<uint4*>(smem + 4 * kPad);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const int idx = threadIdx.x + kThreads * h;
    tw_s[idx] = __ldg(reinterpret_cast<const uint4*>(
                          tables + (idx >> 10) * 4 * kN) + (idx & 1023));
  }
  __syncthreads();
  const uint32_t* ftbl = smem + 4 * kPad + c * 2 * kN;
  uint64_t acc[2][kPer];   // [row][coefficient 16j + i]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[r][i] = 0;

  int which = d0 / ell;                           // 0: a x V_neg, 1: b x V_fold
  int r = (d0 / t_gsw) & 1;
  int k = d0 % t_gsw;
  const uint32_t mask = bits_per >= 32 ? 0xFFFFFFFFu : (1u << bits_per) - 1;
  for (int d = d0; d < d1; ++d) {
    const int64_t* src = (which ? b_ptr : a_ptr) + r * kN + la_base(j);
    const int off = k * bits_per;                 // digit k: bits off ..
    uint32_t v[kPer];
#pragma unroll
    for (int h = 0; h < kPer / 2; ++h) {
      const longlong2 p = __ldg(reinterpret_cast<const longlong2*>(src + la_off(2 * h)));
      // the low word of a 64-bit shift (one funnel shift); zero past bit 63
      v[2 * h] = off < 64 ? static_cast<uint32_t>(static_cast<uint64_t>(p.x) >> off) & mask : 0u;
      v[2 * h + 1] = off < 64 ? static_cast<uint32_t>(static_cast<uint64_t>(p.y) >> off) & mask : 0u;
    }
    if (bits_per > 29) {                          // digits may reach 4q
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_input(v[i], q);
    }
    forward(v, buf_a, buf_b, j, 1 + c, ftbl, q);
    // key column 2*k + r is digit k of row r (gadget_digits); (2 rows, ell,
    // 2 channels, n)
    const uint32_t* key = (which ? v_fold : v_neg) + query * key_stride +
                          static_cast<long long>(2 * k + r) * 2 * kN +
                          c * kN + lc_base(j);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const uint4* kr = reinterpret_cast<const uint4*>(
          key + static_cast<long long>(row) * ell * 2 * kN);
#pragma unroll
      for (int h = 0; h < kPer / 4; ++h) {
        const uint4 kv = __ldg(kr + h);
        acc[row][4 * h] += static_cast<uint64_t>(v[4 * h]) * kv.x;
        acc[row][4 * h + 1] += static_cast<uint64_t>(v[4 * h + 1]) * kv.y;
        acc[row][4 * h + 2] += static_cast<uint64_t>(v[4 * h + 2]) * kv.z;
        acc[row][4 * h + 3] += static_cast<uint64_t>(v[4 * h + 3]) * kv.w;
      }
    }
    if (++k == t_gsw) {
      k = 0;
      if (++r == 2) {
        r = 0;
        ++which;
      }
    }
  }

  const uint64_t mu = sdk::barrett_mu(q);
  uint32_t red[2][kPer];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < kPer; ++i) red[r][i] = sdk::barrett_reduce(acc[r][i], q, mu);

  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();   // the last transform's reads of buf_b are done
    if (rank != 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h)
          reinterpret_cast<uint4*>(buf_a + r * kPad + lc_base(j))[h] = make_uint4(
              red[r][4 * h], red[r][4 * h + 1], red[r][4 * h + 2],
              red[r][4 * h + 3]);
    }
    cl.sync();
    if (rank == 0) {
      for (int rk = 1; rk < cluster; ++rk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4* part = reinterpret_cast<const uint4*>(
              cl.map_shared_rank(buf_a + r * kPad, rk) + lc_base(j));
#pragma unroll
          for (int h = 0; h < kPer / 4; ++h) {
            const uint4 p = part[h];
            red[r][4 * h] += p.x;
            red[r][4 * h + 1] += p.y;
            red[r][4 * h + 2] += p.z;
            red[r][4 * h + 3] += p.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < kPer; ++i) red[r][i] = sdk::barrett_reduce(red[r][i], q, mu);
    }
    cl.sync();         // block 0 has read every partial
    if (rank != 0) return;
  }

  // inverse of row 1 - c (handed to the other group), then of row c (kept)
  uint32_t give[kPer], keep[kPer];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    uint32_t v[kPer];
    const bool row1 = (rr == 0) == (c == 0);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = row1 ? red[1][i] : red[0][i];
    inverse(v, buf_a, buf_b, j, 1 + c, tbl, q);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (rr == 0) give[i] = sdk::ntt_canonical(v[i], q);
      else keep[i] = sdk::ntt_canonical(v[i], q);
    }
  }
  // the group of channel c composes row c from its own channel and the
  // other group's
  to_smem<0>(buf_a, j, give);
  __syncthreads();
  uint32_t other[kPer];
  from_smem<0>(smem + 2 * (c ^ 1) * kPad, j, other);
  const uint64_t mu1 = sdk::barrett_mu(q1);
  int64_t* o_row = o_ptr + c * kN + la_base(j);
#pragma unroll
  for (int h = 0; h < kPer / 2; ++h) {
    longlong2 o;
    o.x = static_cast<long long>(sdk::crt_compose(
        c ? other[2 * h] : keep[2 * h], c ? keep[2 * h] : other[2 * h], q0, q1,
        inv_q0_mod_q1, mu1));
    o.y = static_cast<long long>(sdk::crt_compose(
        c ? other[2 * h + 1] : keep[2 * h + 1],
        c ? keep[2 * h + 1] : other[2 * h + 1], q0, q1, inv_q0_mod_q1, mu1));
    reinterpret_cast<longlong2*>(o_row + la_off(2 * h))[0] = o;
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
  err = cudaFuncSetAttribute(fold_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// in: (entries, 2*num_per, 2, 1, n) int64 raw values mod Q; out: (entries,
// num_per, 2, 1, n) int64; n = 2048. v_neg, v_fold: this round's key
// matrices, (2, 2*t_gsw, 2, n) uint32 each, one per query at a distance of
// key_stride words (0: one key for all); entry e uses query e / rep.
// tables: (2, 4, n). cluster: blocks a slot (1, 2 or 4).
extern "C" int sdk_fold_round(const void* in, void* out, const void* v_neg,
                              const void* v_fold, const void* tables,
                              long long entries, long long num_per,
                              long long rep, long long key_stride, int t_gsw,
                              int bits_per, int log_n, unsigned int q0,
                              unsigned int q1,
                              unsigned long long inv_q0_mod_q1, int cluster,
                              void* stream) {
  const long long slots = entries * num_per;
  if (slots <= 0) return static_cast<int>(cudaGetLastError());
  if (log_n != sdk::core::kLogN || t_gsw < 1 || t_gsw > 15 ||
      (cluster != 1 && cluster != 2 && cluster != 4) ||
      slots * cluster > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slots * cluster));
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
      &cfg, fold_round_kernel, static_cast<const int64_t*>(in),
      static_cast<int64_t*>(out), static_cast<const uint32_t*>(v_neg),
      static_cast<const uint32_t*>(v_fold),
      static_cast<const uint32_t*>(tables), num_per, rep, key_stride, t_gsw,
      bits_per, q0, q1, static_cast<uint64_t>(inv_q0_mod_q1), cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of F an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// negative on an error.
extern "C" int sdk_fold_round_occupancy() {
  int n = 0;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fold_round_kernel, kThreads, kSmemBytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
