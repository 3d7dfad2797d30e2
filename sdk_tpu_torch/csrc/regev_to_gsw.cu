// Regev -> GSW conversion of a whole batch's GSW leaves, with the negated
// folding keys, in one launch (kernel B's redesign). For each (query, GSW leaf i <
// t_gsw * db_dim_2), from the leaf's NTT Regev ct v (2 rows x 2 channels):
//   conv = W (x) G^-1(from_ntt(v))      W the query's (w, w') conversion key
//   v_folding[q, i / t_gsw, row, 2 (i % t_gsw)]     = conv[row]
//   v_folding[q, i / t_gsw, row, 2 (i % t_gsw) + 1] = v[row]
//   v_neg = (gadget_ntt - v_folding) mod q_c   at both columns
//
// Replaces, on the read path, kernel B (matmul_mod.cu) with A' / A around
// it and the torch glue between -- sdk_tpu/ops/spiral_jax.py:787
// regev_to_gsw (from_ntt, gadget_digits, to_ntt, matmul_mod, the stack and
// swapaxes of the folding-key layout) -- and the whole of :809
// get_v_folding_neg (from_ntt, Q - x, to_ntt, add_mod). The negation needs
// no transform: Q = q0 q1, so (Q - x) mod q_c = -x mod q_c, and the NTT is
// linear, so to_ntt(Q - from_ntt(v)) = (q_c - v) mod q_c for canonical v,
// and v_neg is the pointwise (gadget_ntt - v) mod q_c (the plain version,
// ops/spiral.py regev_to_gsw_neg_plain, keeps the transforms).
//
// A block of 256 threads is two groups of the transform core
// (ntt_device.cuh, sdk::core), one a CRT channel, as kernels E and F. Per
// block, the group of channel c, for one (query, leaf):
//   1. loads each row of its channel of v (16 consecutive words a thread,
//      the core's layout Lc), stores it and its negation as column
//      2 (i % t_gsw) + 1 of both outputs, and runs the inverse transform of
//      each row into shared memory;
//   2. with the other group, CRT-composes both rows (Garner, as
//      crt_compose) into 2 x 2048 uint64 words of shared memory;
//   3. for each of its digits kk (digit kk / 2 of row kk % 2, as
//      gadget_digits: bits_per wide, 0 once the offset passes 64 bits):
//      extracts it into the core's first layout, reduces it where it may
//      reach 4q, forward-transforms it and accumulates the Shoup products
//      with W[0, kk] and W[1, kk] (the query's key through the batch's
//      pointer table), each sum kept below 2q in 32 bits;
//   4. stores conv mod q and (gadget - conv) mod q as column 2 (i % t_gsw).
// Nothing between the input and the outputs goes through device memory.
// While the batch's leaves are fewer than the card's SMs (a single read: 42
// leaves at the 1 GiB bucket, 132 SMs), a leaf takes a thread block cluster
// of 2 blocks (ops/spiral.py regev_to_gsw_tiling): block `rank` takes the
// t_conv digits of row `rank` only, so it inverts and composes that one
// row (steps 1-2) and stores that row of the input column, and block 0
// adds block 1's partial sums (< 2q) through distributed shared memory
// before step 4. (A cluster of 4, splitting a row's digits again, was
// slower at a single read; PERF.md.)
//
// What bounds it on the H100: a leaf reads 32 KB and writes 128 KB (both
// outputs' two columns) against 2 inverse and 2 t_conv forward one-channel
// transforms a group; at NQ = 16 the bytes (117 MB, 0.035 ms) and the
// transforms' integer issue are close; at NQ = 1 the latency of one
// block's chain of dependent transforms, which the cluster split shortens.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_device.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sdk::core;

constexpr int kThreads = 2 * kGroup;   // one transform group a CRT channel

// dynamic shared memory: per channel three padded buffers (the core's two
// exchange buffers, then row 0's inverse transform), then the two composed
// rows (2 x kN uint64)
constexpr size_t kSmemBytes =
    sizeof(uint32_t) * 6 * kPad + sizeof(uint64_t) * 2 * kN;

// w * y mod q, lazy in [0, 2q), for w < q, wp = floor(w 2^32 / q), any y
__device__ __forceinline__ uint32_t shoup_mul(uint32_t w, uint32_t wp,
                                              uint32_t y, uint32_t q) {
  return w * y - __umulhi(y, wp) * q;
}

// (g - x) mod q for g, x in [0, q)
__device__ __forceinline__ uint32_t sub_mod(uint32_t g, uint32_t x,
                                            uint32_t q) {
  return g >= x ? g - x : g + q - x;
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

// A column's words x (Lc, canonical) and (gadget - x) mod q to both outputs.
__device__ __forceinline__ void store_column(uint32_t* fold, uint32_t* neg,
                                             const uint32_t* __restrict__ gad,
                                             const uint32_t (&x)[kPer],
                                             uint32_t q) {
  uint32_t g[kPer], o[kPer];
  load16(gad, g);
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = sub_mod(g[i], x[i], q);
  store16(fold, x);
  store16(neg, o);
}

__global__ void __launch_bounds__(kThreads, 2)
regev_to_gsw_kernel(const uint32_t* __restrict__ leaves,
                    const int32_t* __restrict__ pos, long long n_leaves,
                    uint32_t* __restrict__ fold, uint32_t* __restrict__ neg,
                    const uint32_t* __restrict__ gadget,
                    const unsigned long long* __restrict__ keys,
                    const uint32_t* __restrict__ tables, int n_gsw,
                    int t_gsw, int t_conv, int bits, uint32_t q0, uint32_t q1,
                    uint64_t inv_q0_mod_q1, int cluster) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = threadIdx.x / kGroup;
  const int j = threadIdx.x % kGroup;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const long long blk = blockIdx.x / cluster;
  const long long query = blk / n_gsw;
  const int leaf = static_cast<int>(blk % n_gsw);
  const int d = leaf / t_gsw;
  const int col = 2 * (leaf % t_gsw);
  const uint32_t q = c ? q1 : q0;
  uint32_t* buf_a = smem + 3 * c * kPad;           // [channel][buffer]
  uint32_t* buf_b = buf_a + kPad;
  uint32_t* row0_s = buf_b + kPad;                 // row 0's inverse
  uint64_t* comp = reinterpret_cast<uint64_t*>(smem + 6 * kPad);  // [row][kN]

  // words of a (row, column) of the outputs: (2 t_gsw, 2, n) a row
  const long long row_words = 2LL * t_gsw * 2 * kN;
  const long long out0 = (query * (n_gsw / t_gsw) + d) * 2 * row_words;
  const uint32_t* src = leaves + (query * n_leaves + pos[leaf]) * 4LL * kN;
  const uint32_t* ctbl = tables + static_cast<size_t>(c) * 4 * kN;

  // this block's rows: both, or in a cluster row `rank` alone
  const int row_lo = cluster == 1 ? 0 : rank;
  const int row_hi = cluster == 1 ? 2 : rank + 1;

  // 1. each row: the input column to both outputs, then its inverse
  uint32_t v[kPer];
#pragma unroll 1
  for (int row = row_lo; row < row_hi; ++row) {
    load16(src + (row * 2 + c) * kN + lc_base(j), v);
    {
      const long long o = out0 + row * row_words + (col + 1) * 2LL * kN
                          + c * kN + lc_base(j);
      store_column(fold + o, neg + o,
                   gadget + ((row * 2 * t_gsw + col + 1) * 2 + c) * kN
                       + lc_base(j), v, q);
    }
    inverse(v, buf_a, buf_b, j, 1 + c, ctbl, q);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_canonical(v[i], q);
    // row 1's lands in buf_a: every thread of the group is past the
    // transform's last read of it
    to_smem<0>(row == 0 ? row0_s : buf_a, j, v);
  }
  __syncthreads();

  // 2. the block's rows composed to their values below Q
  {
    const uint64_t mu1 = sdk::barrett_mu(q1);
#pragma unroll 4
    for (int m = 0; m < (row_hi - row_lo) * kN / kThreads; ++m) {
      const int e = row_lo * kN + threadIdx.x + kThreads * m;
      const int row = e / kN;
      const int x = e % kN;
      const uint32_t* x0s = smem + (row == 0 ? 2 * kPad : 0);       // ch 0
      const uint32_t* x1s = smem + 3 * kPad + (row == 0 ? 2 * kPad : 0);
      comp[e] = sdk::crt_compose(x0s[pad(x)], x1s[pad(x)], q0, q1,
                                 inv_q0_mod_q1, mu1);
    }
  }
  __syncthreads();

  // 3. this block's digits: digit -> forward transform -> Shoup products
  // with W[row, kk], accumulated below 2q
  const int n_dig = 2 * t_conv;
  const unsigned long long* kp = keys + query * 4;
  const uint32_t* w_key = reinterpret_cast<const uint32_t*>(kp[0]);
  const uint32_t* w_shoup = reinterpret_cast<const uint32_t*>(kp[1]);
  // digits kk (digit kk / 2 of row kk % 2): all, or row_lo's t_conv
  const int n_mine = cluster == 1 ? n_dig : t_conv;
  const uint32_t two_q = 2u * q;
  const uint32_t mask = bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1;
  uint32_t acc[2][kPer];
#pragma unroll
  for (int row = 0; row < 2; ++row)
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[row][i] = 0;
  for (int dk = 0; dk < n_mine; ++dk) {
    const int kk = cluster == 1 ? dk : 2 * dk + row_lo;
    const int off = (kk >> 1) * bits;
    const uint64_t* cr = comp + (kk & 1) * kN;
#pragma unroll
    for (int h = 0; h < kPer / 2; ++h) {
      // coefficients 2j + 256h and 2j + 256h + 1: one 16-byte load
      const ulonglong2 p = reinterpret_cast<const ulonglong2*>(
          cr + la_base(j) + la_off(2 * h))[0];
      v[2 * h] = off < 64 ? static_cast<uint32_t>(p.x >> off) & mask : 0u;
      v[2 * h + 1] = off < 64 ? static_cast<uint32_t>(p.y >> off) & mask : 0u;
    }
    if (bits > 29) {                               // digits may reach 4q
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_input(v[i], q);
    }
    forward(v, buf_a, buf_b, j, 1 + c, ctbl, q);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const long long off_w =
          (static_cast<long long>(row * n_dig + kk) * 2 + c) * kN + lc_base(j);
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
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const uint4* part = reinterpret_cast<const uint4*>(
            cl.map_shared_rank(buf_a + row * kPad, 1) + lc_base(j));
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h) {
          const uint4 p = part[h];
          acc[row][4 * h] += p.x;            // 2 partials < 4q < 2^31
          acc[row][4 * h + 1] += p.y;
          acc[row][4 * h + 2] += p.z;
          acc[row][4 * h + 3] += p.w;
        }
      }
    }
    cl.sync();         // block 0 has read every partial
    if (rank != 0) return;
  }

  // 4. the key product's column to both outputs
#pragma unroll
  for (int row = 0; row < 2; ++row) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = acc[row][i] % q;
    const long long o = out0 + row * row_words + col * 2LL * kN + c * kN
                        + lc_base(j);
    store_column(fold + o, neg + o,
                 gadget + ((row * 2 * t_gsw + col) * 2 + c) * kN + lc_base(j),
                 v, q);
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
  err = cudaFuncSetAttribute(regev_to_gsw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace

// leaves: (nq, n_leaves, 2, 1, 2, n) uint32 NTT cts, canonical; pos: (n_gsw)
// int32 positions of the GSW leaves among them; fold, neg: (nq, n_gsw /
// t_gsw, 2, 2 t_gsw, 2, n) outputs; gadget: (2, 2 t_gsw, 2, n) the gadget
// matrix's NTT; keys: (nq, 2) pointers to each query's (2, 2 t_conv, 2, n)
// conversion key words and their Shoup companions; tables: (2, 4, n).
// cluster: blocks a leaf (1 or 2), n = 2048.
extern "C" int sdk_regev_to_gsw(const void* leaves, const void* pos,
                                long long n_leaves, int nq, void* fold,
                                void* neg, const void* gadget,
                                const void* keys, const void* tables,
                                int n_gsw, int t_gsw, int t_conv, int bits,
                                unsigned int q0, unsigned int q1,
                                unsigned long long inv_q0_mod_q1, int cluster,
                                void* stream) {
  const long long blocks = static_cast<long long>(nq) * n_gsw * cluster;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  if ((cluster != 1 && cluster != 2) || blocks > 0x7FFFFFFFLL || t_gsw < 1 ||
      n_gsw % t_gsw != 0 || t_conv < 1 || bits < 1 || bits > 64) {
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
      &cfg, regev_to_gsw_kernel, static_cast<const uint32_t*>(leaves),
      static_cast<const int32_t*>(pos), n_leaves,
      static_cast<uint32_t*>(fold), static_cast<uint32_t*>(neg),
      static_cast<const uint32_t*>(gadget),
      static_cast<const unsigned long long*>(keys),
      static_cast<const uint32_t*>(tables), n_gsw, t_gsw, t_conv, bits, q0,
      q1, static_cast<uint64_t>(inv_q0_mod_q1), cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on an error.
extern "C" int sdk_regev_to_gsw_occupancy() {
  int n = 0;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, regev_to_gsw_kernel, kThreads, kSmemBytes);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
