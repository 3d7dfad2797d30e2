// DoublePIR's wrapping 32-bit products (kernel L): (M, K) uint32 @ (K, N)
// uint32 -> (M, N) uint32 mod 2^32, and the packed form whose left operand
// holds three 10-bit fields per word.
//
// Replaces sdk_tpu/doublepir/jax_kernels.py:35 matmul_u32_traced and its
// packed callers :84 mat_mul_vec_packed_traced and :109
// mat_mul_transposed_packed_traced (with :72 unsquish_traced). The JAX
// program cuts both operands into 7-bit int8 limbs for the MXU, chunks K at
// 2^16 so the int32 limb sums stay exact, and unsquishes the packed operand
// into a copy (in row chunks, to bound that copy). Here the multiply-add is
// the native wrapping one, any K is exact, and the packed form extracts
// field k % 3 of word k / 3 with a shift and a mask while it fills the
// shared-memory tile, so no unsquished copy is written.
//
// One templated kernel: a block computes a BM x BN output tile over one
// split of K, in steps of 32 through shared memory, and adds its sums into
// the zeroed output with atomicAdd (unsigned adds wrap, so the result does
// not depend on the order). Three tile shapes, chosen by the wrapper's
// shapes:
//   M <= 8  (the answer: msg0 = a_1t @ A2 with M = 4, K = 92682, N = 1024;
//            h_2 = a_1t @ q2): 8 x 256 tiles, many K splits, so the work
//            spreads over K and N, not over M. Bound by bytes: b is read
//            once.
//   N <= 8  (packed DB rows @ a query column, general configs): 256 x 8.
//   else    (setup products of general configs): 64 x 64, 4 x 4 per thread.
//           Bound by operations.
//
// The checklist answer's two products of one packed left operand, msg0 =
// unsquish(a_1t) @ A2 and h_2 = unsquish(a_1t) @ q2 (M = delta rows, K =
// 92682, A2 (K, 1024) = 380 MB, q2 (K, nq)), run as one launch of a second
// kernel, answer_kernel (sdk_dp_answer_u32): bound by A2's bytes, read once.
// Every block takes a contiguous run of K rows of both operands and all
// their columns, so each block streams one contiguous stretch of A2 (4 KB a
// row, ~1.4 MB a block at 264 blocks). A thread owns four columns of A2 and
// copies its 16 bytes of each row into a private slot of an 8-row cp.async
// ring in shared memory (cp.async.cg, 16 bytes, L2 only): each thread reads
// back only its own slots, so the ring needs no barrier, only
// cp.async.wait_group, and 7 rows (28 KB a block, 56 KB an SM at two
// blocks) stay in flight, several times what the HBM rate times the load
// latency asks. cp.async rather than TMA: a TMA ring would need a producer
// warp and mbarriers for what is here a per-thread copy of 16 bytes a row
// with no reuse across threads. The packed operand is unsquished once a
// block, 512 rows at a time, into shared memory (field k % 3 of word k / 3,
// a row's M values side by side for one broadcast load); q2's few columns
// are read by plain loads as each chunk is unsquished (nq columns of
// 4 bytes, 1% of the bytes). The wrapping sums are order-free: the blocks of
// a thread block cluster of 4 (neighbouring K runs) add their partial msg0
// through distributed shared memory, each block then adds a quarter of the
// cluster's sums into the output with atomicAdd, and h_2's partials of a
// block are summed in shared memory before their atomicAdd. The output is
// zeroed by the wrapper's one memset of both products' buffer. The grid is
// one wave of clusters (cudaOccupancyMaxActiveClusters, two blocks an SM).

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BK = 32;
constexpr int kSquishBits = 10;   // matrix.py SQUISH_BASIS
constexpr int kSquishFields = 3;  // matrix.py SQUISH_DELTA

template <int BM, int BN, int TM, int TN, bool PACKED>
__global__ void __launch_bounds__(kThreads)
matmul_u32_kernel(const uint32_t* __restrict__ a, long long lda,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  long long M, int K, int N, int k_per_split) {
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kThreads, "one thread per TM x TN sub-tile");
  // a row-major and padded by one word: the fill writes along k and the
  // product reads along rows, both without bank conflicts
  __shared__ uint32_t a_s[BM][BK + 1];
  __shared__ uint32_t b_s[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = kbeg + k_per_split < K ? kbeg + k_per_split : K;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, kk = i % BK;
      const int k = k0 + kk;
      uint32_t v = 0;
      if (m0 + r < M && k < kend) {
        if (PACKED) {
          const uint32_t w = a[(m0 + r) * lda + k / kSquishFields];
          v = (w >> (kSquishBits * (k % kSquishFields))) &
              ((1u << kSquishBits) - 1);
        } else {
          v = a[(m0 + r) * lda + k];
        }
      }
      a_s[r][kk] = v;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int kk = i / BN, n = i % BN;
      b_s[kk][n] = (k0 + kk < kend && n0 + n < N)
                       ? b[static_cast<long long>(k0 + kk) * N + n0 + n] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint32_t av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[ty * TM + i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) atomicAdd(&out[m * N + n], acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN, bool PACKED>
cudaError_t launch_shape(const uint32_t* a, long long lda, const uint32_t* b,
                         uint32_t* out, long long M, int K, int N,
                         cudaStream_t stream) {
  const long long tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  // enough blocks for four waves over 132 SMs, each split a multiple of BK
  long long splits = (4 * 132 + tiles - 1) / tiles;
  const int ksteps = (K + BK - 1) / BK;
  if (splits > ksteps) splits = ksteps;
  if (splits < 1) splits = 1;
  const int k_per_split =
      static_cast<int>((ksteps + splits - 1) / splits) * BK;
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM),
                  (K + k_per_split - 1) / k_per_split);
  matmul_u32_kernel<BM, BN, TM, TN, PACKED><<<grid, kThreads, 0, stream>>>(
      a, lda, b, out, M, K, N, k_per_split);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch(const uint32_t* a, long long lda, const uint32_t* b,
                   uint32_t* out, long long M, int K, int N,
                   cudaStream_t stream) {
  if (M <= 8)
    return launch_shape<8, 256, 8, 1, PACKED>(a, lda, b, out, M, K, N, stream);
  if (N <= 8)
    return launch_shape<256, 8, 1, 8, PACKED>(a, lda, b, out, M, K, N, stream);
  return launch_shape<64, 64, 4, 4, PACKED>(a, lda, b, out, M, K, N, stream);
}

// ---------------------------------------------------------------------------
// The answer's fused msg0 / h_2 launch.

namespace cg = cooperative_groups;

constexpr int kAnsStages = 8;       // rows of the cp.async ring
constexpr int kAnsChunk = 512;      // rows of the packed operand unsquished at once
constexpr int kAnsMaxM = 8;         // rows of the packed operand
constexpr int kAnsCluster = 4;      // blocks a cluster, neighbouring K runs
constexpr int kAnsMaxN1 = kThreads; // columns of the second product
// dynamic shared memory: the ring (uint4 a thread a row), then the
// unsquished chunk (kAnsMaxM words a row)
constexpr size_t kAnsSmem =
    sizeof(uint4) * kAnsStages * kThreads + sizeof(uint32_t) * kAnsChunk * kAnsMaxM;
static_assert(kAnsMaxM * 1024 * sizeof(uint32_t) <=
                  sizeof(uint4) * kAnsStages * kThreads,
              "the ring holds a pass's partial sums");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out0 += unsquish(a) @ b0 and out1 += unsquish(a) @ b1 over this block's
// rows [k0, k1) (atomicAdd into zeroed outputs). kVec: b0's rows are
// 16-byte aligned (N0 % 4 == 0), copied 16 bytes at a time; else 4.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
answer_kernel(const uint32_t* __restrict__ a, long long lda, int M,
              const uint32_t* __restrict__ b0, int N0,
              uint32_t* __restrict__ out0, const uint32_t* __restrict__ b1,
              int N1, uint32_t* __restrict__ out1, int K,
              int rows_per_block) {
  extern __shared__ __align__(16) unsigned char ans_smem[];
  uint4* ring = reinterpret_cast<uint4*>(ans_smem);                 // [S][T]
  uint32_t* a_s = reinterpret_cast<uint32_t*>(ring + kAnsStages * kThreads);
  const int t = threadIdx.x;
  const long long k0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nrows = static_cast<int>(
      k0 >= K ? 0 : (K - k0 < rows_per_block ? K - k0 : rows_per_block));
  const int q0 = (N0 + 3) / 4;                  // column quads of b0
  const int passes = (q0 + kThreads - 1) / kThreads;
  // h_2: thread t takes column t % N1 of every (256 / N1)-th row
  const int p1 = kThreads / N1;
  const int n1 = t % N1;
  const int ph = t / N1;
  const bool on1 = ph < p1;
  constexpr uint32_t kField = (1u << kSquishBits) - 1;

  uint32_t acc1[kAnsMaxM];
#pragma unroll
  for (int m = 0; m < kAnsMaxM; ++m) acc1[m] = 0;

  for (int pass = 0; pass < passes; ++pass) {
    const int cq = t + kThreads * pass;
    const bool on0 = cq < q0;
    uint32_t acc[kAnsMaxM][4];
#pragma unroll
    for (int m = 0; m < kAnsMaxM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0;

    // row i of the block into its ring slot (an empty group past the end)
    auto issue = [&](int i) {
      if (i < nrows && on0) {
        const uint32_t* src = b0 + (k0 + i) * N0 + 4 * cq;
        uint4* dst = ring + (i % kAnsStages) * kThreads + t;
        if constexpr (kVec) {
          cp_async16(dst, src, 16);
        } else {
          uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = 4 * cq + e < N0;
            cp_async4(d + e, in ? src + e : b0, in ? 4 : 0);
          }
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kAnsStages - 1; ++i) issue(i);

    for (int i = 0; i < nrows; ++i) {
      if (i % kAnsChunk == 0) {
        // unsquish the next chunk of rows; h_2 over it in the first pass
        const int len = nrows - i < kAnsChunk ? nrows - i : kAnsChunk;
        __syncthreads();                       // the last chunk is read
        for (int e = t; e < len * M; e += kThreads) {
          const int r = e / M, m = e % M;
          const long long k = k0 + i + r;
          const uint32_t w = __ldg(a + m * lda + k / kSquishFields);
          a_s[r * kAnsMaxM + m] =
              (w >> (kSquishBits * static_cast<int>(k % kSquishFields))) &
              kField;
        }
        __syncthreads();
        if (pass == 0 && on1) {
#pragma unroll 4
          for (int r = ph; r < len; r += p1) {
            const uint32_t y = __ldg(b1 + (k0 + i + r) * N1 + n1);
            const uint4 lo = *reinterpret_cast<const uint4*>(a_s + r * kAnsMaxM);
            acc1[0] += lo.x * y; acc1[1] += lo.y * y;
            acc1[2] += lo.z * y; acc1[3] += lo.w * y;
            if (M > 4) {
              const uint4 hi =
                  *reinterpret_cast<const uint4*>(a_s + r * kAnsMaxM + 4);
              acc1[4] += hi.x * y; acc1[5] += hi.y * y;
              acc1[6] += hi.z * y; acc1[7] += hi.w * y;
            }
          }
        }
      }
      issue(i + kAnsStages - 1);
      cp_async_wait<kAnsStages - 1>();           // row i has landed
      if (on0) {
        const uint4 x = ring[(i % kAnsStages) * kThreads + t];
        const uint32_t* ar = a_s + (i % kAnsChunk) * kAnsMaxM;
        const uint4 lo = *reinterpret_cast<const uint4*>(ar);
        const uint32_t av[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[m][0] += av[m] * x.x; acc[m][1] += av[m] * x.y;
          acc[m][2] += av[m] * x.z; acc[m][3] += av[m] * x.w;
        }
        if (M > 4) {
          const uint4 hi = *reinterpret_cast<const uint4*>(ar + 4);
          const uint32_t bv[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[4 + m][0] += bv[m] * x.x; acc[4 + m][1] += bv[m] * x.y;
            acc[4 + m][2] += bv[m] * x.z; acc[4 + m][3] += bv[m] * x.w;
          }
        }
      }
    }
    cp_async_wait<0>();

    // the cluster's partial sums of this pass's 1024 columns: each block
    // stores its own into the ring, then adds a quarter of all of them
    // into out0
    cg::cluster_group cl = cg::this_cluster();
    __syncthreads();                             // every ring read is done
    uint32_t* part = reinterpret_cast<uint32_t*>(ring);   // [m][1024]
#pragma unroll
    for (int m = 0; m < kAnsMaxM; ++m) {
      if (m < M) {
        reinterpret_cast<uint4*>(part + m * 1024)[t] =
            make_uint4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
    cl.sync();
    const int words = M * 1024;
    const int rank = static_cast<int>(cl.block_rank());
    const int w0 = rank * words / kAnsCluster;
    const int w1 = (rank + 1) * words / kAnsCluster;
    for (int w = w0 + t; w < w1; w += kThreads) {
      uint32_t sum = 0;
#pragma unroll
      for (int rk = 0; rk < kAnsCluster; ++rk) sum += cl.map_shared_rank(part, rk)[w];
      const int col = kThreads * 4 * pass + w % 1024;
      if (col < N0 && sum != 0u) atomicAdd(out0 + (w / 1024) * N0 + col, sum);
    }
    cl.sync();                                   // every rank's part is read
  }

  // h_2: the block's partials summed over the row phases, then added
  uint32_t* hp = a_s;                            // [thread][kAnsMaxM]
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kAnsMaxM; ++m) hp[t * kAnsMaxM + m] = acc1[m];
  __syncthreads();
  for (int w = t; w < N1 * M; w += kThreads) {
    const int m = w / N1, n = w % N1;
    uint32_t sum = 0;
    for (int p = 0; p < p1; ++p) sum += hp[(p * N1 + n) * kAnsMaxM + m];
    if (sum != 0u) atomicAdd(out1 + m * N1 + n, sum);
  }
}

// Clusters of answer_kernel that fit the card at once, once a device.
int answer_clusters(cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < kMaxDevices && cached[dev].load(std::memory_order_acquire) > 0) {
    return cached[dev].load(std::memory_order_acquire);
  }
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kAnsCluster * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kAnsSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kAnsCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, answer_kernel<true>, &cfg) !=
          cudaSuccess || n < 1) {
    return -1;
  }
  n = n < 2 * sms / kAnsCluster ? n : 2 * sms / kAnsCluster;   // two an SM
  if (dev < kMaxDevices) cached[dev].store(n, std::memory_order_release);
  return n;
}

}  // namespace

// The checklist answer's msg0 and h_2 in one launch: out0 (M, N0) +=
// unsquish(a) @ b0 and out1 (M, N1) += unsquish(a) @ b1, a: (M, K / 3)
// words of three 10-bit fields with row stride lda words, b0: (K, N0), b1:
// (K, N1) uint32; out0 and out1 zeroed by the caller. M <= 8, N1 <= 256,
// K a multiple of 3.
extern "C" int sdk_dp_answer_u32(const void* a, long long lda, int M,
                                 const void* b0, int N0, void* out0,
                                 const void* b1, int N1, void* out1, int K,
                                 void* stream) {
  if (M < 1 || M > kAnsMaxM || N0 < 1 || N1 < 1 || N1 > kAnsMaxN1 || K < 3 ||
      K % kSquishFields != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int clusters = answer_clusters(s);
  if (clusters < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int blocks = clusters * kAnsCluster;
  const int rows_per_block = (K + blocks - 1) / blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kAnsSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kAnsCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = N0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b0) % 16 == 0;
  const auto* aa = static_cast<const uint32_t*>(a);
  const auto* bb0 = static_cast<const uint32_t*>(b0);
  const auto* bb1 = static_cast<const uint32_t*>(b1);
  auto* o0 = static_cast<uint32_t*>(out0);
  auto* o1 = static_cast<uint32_t*>(out1);
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, answer_kernel<true>, aa, lda, M, bb0, N0,
                               o0, bb1, N1, o1, K, rows_per_block)
          : cudaLaunchKernelEx(&cfg, answer_kernel<false>, aa, lda, M, bb0,
                               N0, o0, bb1, N1, o1, K, rows_per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the answer launch (clusters x 4); negative on an error.
extern "C" int sdk_dp_answer_blocks() {
  const int clusters = answer_clusters(nullptr);
  return clusters < 1 ? -1 : clusters * kAnsCluster;
}

// a: (M, K) uint32 with row stride lda words, or with packed != 0 (M,
// ceil(K / 3)) words of three 10-bit fields, field k % 3 of word k / 3 being
// element k; b: (K, N) uint32; out: (M, N) uint32, zeroed by the caller: the
// kernel adds into it.
extern "C" int sdk_dp_matmul_u32(const void* a, long long lda, const void* b,
                                 void* out, long long M, int K, int N,
                                 int packed, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* aa = static_cast<const uint32_t*>(a);
  const auto* bb = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = packed ? launch<true>(aa, lda, bb, o, M, K, N, s)
                                : launch<false>(aa, lda, bb, o, M, K, N, s);
  return static_cast<int>(rc);
}
