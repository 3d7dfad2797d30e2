// Ciphertext packing (kernel G), fused: the n*n folded scalar ciphertexts of
// one (query, instance) become one (n+1) x n matrix ciphertext, for every
// query and instance of the batch in one launch; in its out_words mode the
// same launch also takes the packed matrix out of the NTT domain, rescales
// it and bit-packs the wire response (kernel D's work), so a read or a
// batch of reads makes one launch from the folded ciphertexts to the words.
//
// Replaces sdk_tpu/ops/spiral_jax.py:878 pack (both params.version
// branches, :893-913), the from_ntt that follows it in
// sdk_tpu/ops/server_jax.py:385 _pack_impl, and in out_words mode the
// response encode after it (sdk_tpu/ops/encode_jax.py:99, run together by
// server_jax.py:398 _pack_encode_impl). Three output modes: out_ntt (what
// pack returns: NTT residues), out_raw (+ from_ntt: raw int64 values mod
// Q), out_words (+ rescale and bit-pack: the response's uint32 words).
//
// One block (or a cluster, below) per (query, instance, column c), of
// `pairs` pairs of transform-core groups (ntt_device.cuh, sdk::core: 128
// threads a 2048-point polynomial, 16 coefficients a thread), a group a CRT
// channel: 256 * pairs threads. Per r, with ct = v_ct[r*n + c], the 1 + t_conv
// independent forward transforms (to_ntt of ct[1], to_ntt of the t_conv
// gadget digits of ct[0]) run side by side, a pair each, in rounds of
// `pairs`; each group leaves its transform in its exchange buffer, and after
// a block barrier every thread combines, for its own quads of words (row,
// channel, 4 coefficients), the round's key products and ct[1] into the
// running sums with 64-bit accumulators and one reduction each:
//   version 0: v_int[row]           += key_r[row][k] * y_k, v_int[1+r] += ct2
//   version 1: prod = w_key @ y (+ ct2 in row 1), then r shift steps, each
//              prod = w_shift @ to_ntt(G^-1(from_ntt(prod[0])))
//                     + [0, prod[n], prod[1], ..., prod[n-1]]
// The shift only rotates rows 1..n, so they go straight into v_int at the
// row they will have reached after the remaining steps, and only row 0 is
// kept apart (prod0); a shift step is one inverse transform of prod0 (the
// first pair), the CRT compose of its 2048 values by the whole block, the
// t_conv digit transforms side by side, then the combine with w_shift into
// prod0, or into v_int[0] at the last step. Sums are exact mod q in any
// grouping, so every tiling stores the same words.
// The r's are independent until the v_int sum. With `cluster` = n (from
// ops/spiral.py:pack_tiling, when the batch leaves SMs idle) a (query,
// instance, column) takes a cluster of n blocks, block `rank` running r =
// rank's chain alone into its own partial v_int; after a cluster barrier
// block rank sums rows rank, rank + n, ... of every block's partial through
// distributed shared memory and takes them through the final stage, so the
// chain is that of r = n - 1 alone. With `cluster` = 1 one block runs every
// r in turn.
// Final: out_ntt copies v_int; out_raw and out_words inverse-transform the
// n+1 rows side by side, a pair a row, and the whole block CRT-composes
// each coefficient from both channels' residues; out_words rescales each
// value (encode_device.cuh, the arithmetic kernel D runs), stages each
// row's 2048 values in shared memory and writes the rows' whole words, the
// block's threads spread over all of them. Each (instance,
// row, column) segment is 2048 values of q2_bits (row 0) or q1_bits: 64 x
// bits words, starting on a word boundary, so the blocks' word ranges are
// disjoint (row 0, column c at inst_off + c * 64 q2_bits; row r >= 1 at
// inst_off + 64 (n q2_bits + ((r-1) n + c) q1_bits); modelled by
// tests/test_torch_pack_encode.py) and no atomics or second pass are needed.
//
// Residues stay canonical: ct[1] is Barrett-reduced, digits above 4q are
// reduced before their transform, lazy transform outputs (< 4q) only enter
// 64-bit sums that are reduced once, inverse inputs are canonical, and
// every composed value lies in [0, Q).
//
// What bounds it on the H100: the issue rate of one SM. One block's chain
// at n = 2, t_conv = 3, version 1 is five rounds of dependent transforms (r
// = 0's, r = 1's, the shift step's inverse and digit round, the final
// inverse of the three rows), 30 one-channel transforms in all, four rounds
// in a cluster's block r = 1; with 8 groups an SM a round is issue-bound,
// not latency-bound (a round of eight takes ~3x one pair's transform alone:
// tools/pack_phases_gpu.py). One block an SM (1024 threads, 64 registers,
// ~212 KB of shared memory): a read has instances * n = 8 (query, instance,
// column)s, a 16-batch 128, one wave of single blocks. The combines (a quad a thread, the round's key words as 16-byte
// loads issued together, a 32-bit two-part reduction) and the encode's
// 32-bit Shoup arithmetic keep the rest of the chain short.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "encode_device.cuh"
#include "ntt_device.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace sdk::core;

constexpr int kMaxPairs = 4;
constexpr int kMaxThreads = 2 * kGroup * kMaxPairs;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kOutNtt = 0, kOutRaw = 1, kOutWords = 2;

// Reduction mod q (q < 2^30) of any 64-bit sum in 32-bit operations: acc =
// hi 2^32 + lo, hi (2^32 mod q) by a Shoup product (r32, its Shoup word
// r32s), lo by the quotient estimate floor(lo m / 2^32), m = floor(2^32 /
// q); each part lies in [0, 2q), so two subtractions make the sum
// canonical. About ten instructions, where a 64-bit Barrett takes fifteen.
struct Reducer {
  uint32_t q, r32, r32s, m;
  __device__ __forceinline__ uint32_t operator()(uint64_t acc) const {
    const uint32_t hi = static_cast<uint32_t>(acc >> 32);
    const uint32_t lo = static_cast<uint32_t>(acc);
    uint32_t t = (r32 * hi - __umulhi(hi, r32s) * q) + (lo - __umulhi(lo, m) * q);
    t = min(t, t - 2 * q);
    return min(t, t - q);
  }
};

struct PackArgs {
  const int64_t* v_ct;            // (NQ, inst, n*n, 2, 1, z)
  const uint32_t* const* keys;    // (NQ, nkeys) pointers to (n+1, t_conv, 2, z)
  const uint32_t* tables;         // (2, 4, z)
  void* out;
  int mode, instances, n, t_conv, bits_per, version, pairs, cluster;
  uint32_t q0, q1;
  long long num_words;            // words of one query's response (out_words)
  sdk::EncodeConsts enc;
  Reducer red[2];                 // the combine's reduction mod q0, q1
};

// Row `row` (1..n) after `k` more shift steps: rows 1..n rotate by one a
// step (row n -> 1).
__device__ __forceinline__ int rotated(int row, int k, int n) {
  return (row - 1 + k) % n + 1;
}

// Word offset of quad Q (coefficients 4Q .. 4Q+3) of a transform stored for
// the combine: quad Q ^ ((Q >> 3) & 7), so that both the transform's stores
// (thread j: quads 4j .. 4j+3) and the combine's loads (thread t: quad t)
// are 16-byte accesses without bank conflicts.
__device__ __forceinline__ int quad_word(int Q) {
  return 4 * (Q ^ ((Q >> 3) & 7));
}

// The transform in v (the core's last layout, coefficient 16 j + i) into
// buf, 16-byte stores: the combine reads it a quad at a time.
__device__ __forceinline__ void store_lc(uint32_t* buf, int j,
                                         const uint32_t (&v)[kPer]) {
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    reinterpret_cast<uint4*>(buf + quad_word(4 * j + h))[0] =
        make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  }
}

// Where one source row of a round's products goes: its destination words,
// whether they start from zero, and whether ct[1]'s transform joins them.
struct RowDest {
  uint32_t* dst;
  bool fresh, add_ct2;
};

// The round's key words of one quad of one source row (zero where a task
// has no key): 16-byte loads.
__device__ __forceinline__ void load_keys(uint4 (&kv)[kMaxPairs],
                                          const uint32_t* __restrict__ krow,
                                          int k0, int ntasks, int cw, int x) {
#pragma unroll
  for (int tt = 0; tt < kMaxPairs; ++tt) {
    kv[tt] = make_uint4(0, 0, 0, 0);
    if (tt < ntasks && k0 + tt >= 0) {
      kv[tt] = __ldg(reinterpret_cast<const uint4*>(
          krow + (static_cast<size_t>(k0 + tt) * 2 + cw) * kN + x));
    }
  }
}

// One round's combine, a quad (4 consecutive words) of every row a thread:
// for source row `row`, dest(row).dst = (fresh ? 0 : dst) + sum over the
// round's tasks tt < ntasks of key_k * y_tt, k = k0 + tt, where k < 0 is
// ct[1]'s transform, added as it is where add_ct2; y_tt is the lazy
// transform (< 4q) that group 2 tt + channel left in its buffer A
// (store_lc), key_k the row's digit-k key words (key + row * key_row + (2 k
// + channel) kN), a row's four 16-byte loads issued together. (Loading the
// next row's key words during a row's products spills at 64 registers and
// ran 15% slower.)
template <typename Dest>
__device__ __forceinline__ void combine(
    const Dest& dest, int rows, const uint32_t* __restrict__ key,
    size_t key_row, int k0, int ntasks, const uint32_t* smem, int tid,
    int nthreads, const Reducer& red0, const Reducer& red1) {
  for (int qd = tid; qd < 2 * kN / 4; qd += nthreads) {
    const int cw = qd / (kN / 4);
    const int x = 4 * (qd % (kN / 4));
    const Reducer rd = cw ? red1 : red0;
    for (int row = 0; row < rows; ++row) {
      uint4 kv[kMaxPairs];
      load_keys(kv, key + row * key_row, k0, ntasks, cw, x);
      const RowDest d = dest(row);
      uint4* dq = reinterpret_cast<uint4*>(d.dst + cw * kN + x);
      uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      if (!d.fresh) {
        const uint4 o = dq[0];
        a0 = o.x; a1 = o.y; a2 = o.z; a3 = o.w;
      }
#pragma unroll
      for (int tt = 0; tt < kMaxPairs; ++tt) {
        if (tt >= ntasks) break;
        const uint4 y = reinterpret_cast<const uint4*>(
            smem + 2 * (2 * tt + cw) * kPad + quad_word(x / 4))[0];
        if (k0 + tt >= 0) {
          a0 += static_cast<uint64_t>(y.x) * kv[tt].x;
          a1 += static_cast<uint64_t>(y.y) * kv[tt].y;
          a2 += static_cast<uint64_t>(y.z) * kv[tt].z;
          a3 += static_cast<uint64_t>(y.w) * kv[tt].w;
        } else if (d.add_ct2) {
          a0 += y.x; a1 += y.y; a2 += y.z; a3 += y.w;
        }
      }
      dq[0] = make_uint4(rd(a0), rd(a1), rd(a2), rd(a3));
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1) pack_kernel(PackArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid / kGroup;               // group: pair g / 2, channel g & 1
  const int p = g >> 1;
  const int c = g & 1;
  const int j = tid % kGroup;
  const int n = a.n;
  const int rows = n + 1;
  const int P = a.pairs;
  // exchange buffers [group][2][kPad], v_int [rows][2][kN], then for
  // version 1 prod0 [2][kN] and the shift step's composed values res64 [kN]
  uint32_t* buf_a = smem + 2 * g * kPad;
  uint32_t* buf_b = buf_a + kPad;
  uint32_t* v_int = smem + 4 * P * kPad;
  uint32_t* prod0 = v_int + rows * 2 * kN;
  uint64_t* res64 = reinterpret_cast<uint64_t*>(prod0 + 2 * kN);

  // a cluster of `cs` blocks a (query, instance, column): 1, or n, one r
  // a block (rank r)
  const int cs = a.cluster;
  const int rank = blockIdx.x % cs;
  const int blk = blockIdx.x / cs;
  const int col = blk % n;
  const int inst = (blk / n) % a.instances;
  const int query = blk / (n * a.instances);
  const int r_begin = cs == 1 ? 0 : rank;
  const int r_end = cs == 1 ? n : rank + 1;
  const uint32_t* const* keys =
      a.keys + static_cast<size_t>(query) * (a.version == 0 ? n : 2);
  const uint32_t q = c ? a.q1 : a.q0;
  const uint64_t mu = sdk::barrett_mu(q);
  const uint32_t* tbl = a.tables + static_cast<size_t>(c) * 4 * kN;
  const int tc = a.t_conv;
  const size_t key_row = static_cast<size_t>(tc) * 2 * kN;  // words a key row

  for (int r = r_begin; r < r_end; ++r) {
    const int64_t* ct =
        a.v_ct + ((static_cast<size_t>(query) * a.instances + inst) * n * n +
                  r * n + col) * 2 * kN;
    const uint32_t* key = a.version == 0 ? keys[r] : keys[0];
    // initial products: task 0 is to_ntt(ct[1]), task 1 + k digit k of ct[0]
    const int ntasks = 1 + tc;
    const int ct2_row = a.version == 0 ? 1 + r : rotated(1, r, n);
    for (int t0 = 0; t0 < ntasks; t0 += P) {
      const int task = t0 + p;
      if (task < ntasks) {
        const int64_t* src = ct + (task == 0 ? kN : 0) + la_base(j);
        uint32_t v[kPer];
#pragma unroll
        for (int h = 0; h < kPer / 2; ++h) {
          const longlong2 x =
              __ldg(reinterpret_cast<const longlong2*>(src + la_off(2 * h)));
          if (task == 0) {
            v[2 * h] = sdk::barrett_reduce(x.x, q, mu);
            v[2 * h + 1] = sdk::barrett_reduce(x.y, q, mu);
          } else {
            v[2 * h] = sdk::ntt_input(
                sdk::gadget_digit(x.x, task - 1, a.bits_per), q);
            v[2 * h + 1] = sdk::ntt_input(
                sdk::gadget_digit(x.y, task - 1, a.bits_per), q);
          }
        }
        forward(v, buf_a, buf_b, j, 1 + g, tbl, q);
        store_lc(buf_a, j, v);             // lazy < 4q, read by the combine
      }
      __syncthreads();
      // combine: row 0 goes to v_int (version 0, or r = 0) or prod0, the
      // other rows to v_int at the row they reach after the r shift steps;
      // the block's first round writes every row it reaches afresh
      const auto dest = [&](int row) {
        const bool to_prod0 = a.version != 0 && r > 0 && row == 0;
        const int dst_row =
            a.version == 0 || row == 0 ? row : rotated(row, r, n);
        return RowDest{to_prod0 ? prod0 : v_int + dst_row * 2 * kN,
                       t0 == 0 && (to_prod0 || r == r_begin),
                       dst_row == ct2_row && !to_prod0};
      };
      combine(dest, rows, key, key_row, t0 - 1, min(P, ntasks - t0), smem,
              tid, nthreads, a.red[0], a.red[1]);
      __syncthreads();
    }

    // version 1: r shift steps on prod0
    for (int s = 0; s < (a.version == 0 ? 0 : r); ++s) {
      const bool last = s == r - 1;
      if (p == 0) {                        // from_ntt(prod0): residues
        uint32_t v[kPer];
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h) {
          const uint4 u = reinterpret_cast<const uint4*>(prod0 + c * kN + lc_base(j))[h];
          v[4 * h] = u.x; v[4 * h + 1] = u.y; v[4 * h + 2] = u.z; v[4 * h + 3] = u.w;
        }
        inverse(v, buf_a, buf_b, j, 1 + g, tbl, q);
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_canonical(v[i], q);
        to_smem<0>(buf_a, j, v);
      }
      __syncthreads();
      // the block composes the 2048 values once (channel 0's and 1's
      // residues in groups 0's and 1's buffer A)
      for (int x = tid; x < kN; x += nthreads) {
        res64[x] = sdk::compose(smem[pad(x)], smem[2 * kPad + pad(x)], a.enc);
      }
      __syncthreads();
      for (int t0 = 0; t0 < tc; t0 += P) {
        const int k = t0 + p;
        if (k < tc) {
          uint32_t v[kPer];
#pragma unroll
          for (int h = 0; h < kPer / 2; ++h) {
            const ulonglong2 x = reinterpret_cast<const ulonglong2*>(
                res64 + la_base(j) + la_off(2 * h))[0];
            v[2 * h] = sdk::ntt_input(sdk::gadget_digit(x.x, k, a.bits_per), q);
            v[2 * h + 1] =
                sdk::ntt_input(sdk::gadget_digit(x.y, k, a.bits_per), q);
          }
          forward(v, buf_a, buf_b, j, 1 + g, tbl, q);
          store_lc(buf_a, j, v);
        }
        __syncthreads();
        // row 0 into prod0, or at the last step into v_int[0], afresh in
        // a cluster's block (its only r, so v_int[0] is not written yet)
        const auto dest = [&](int row) {
          const bool to_prod0 = row == 0 && !last;
          return RowDest{
              to_prod0 ? prod0
                       : v_int + (row == 0 ? 0 : rotated(row, r - 1 - s, n)) * 2 * kN,
              t0 == 0 && (to_prod0 || (row == 0 && cs > 1)), false};
        };
        combine(dest, rows, keys[1], key_row, t0, min(P, tc - t0), smem, tid,
                nthreads, a.red[0], a.red[1]);
        __syncthreads();
      }
    }
  }

  // a cluster sums its blocks' partial v_int: block `rank` takes rows
  // rank, rank + cs, ... (own(i)), adding the other blocks' rows through
  // distributed shared memory into its own; a block writes only its own
  // rows, which no other block reads, and none exits before every block
  // has read its rows
  const auto own = [&](int i) { return rank + i * cs; };
  const int nown = (rows - rank + cs - 1) / cs;
  if (cs > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (int i = 0; i < nown; ++i) {
      uint32_t* mine = v_int + own(i) * 2 * kN;
      for (int w = tid; w < 2 * kN / 4; w += nthreads) {
        const uint32_t qw = w < kN / 4 ? a.q0 : a.q1;
        uint4 acc = reinterpret_cast<const uint4*>(mine)[w];
        for (int rk = 0; rk < cs; ++rk) {
          if (rk == rank) continue;
          const uint4 o = reinterpret_cast<const uint4*>(
              cl.map_shared_rank(mine, rk))[w];
          acc.x = min(acc.x + o.x, acc.x + o.x - qw);
          acc.y = min(acc.y + o.y, acc.y + o.y - qw);
          acc.z = min(acc.z + o.z, acc.z + o.z - qw);
          acc.w = min(acc.w + o.w, acc.w + o.w - qw);
        }
        reinterpret_cast<uint4*>(mine)[w] = acc;
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
  }

  const size_t out_row0 =
      (static_cast<size_t>(query) * a.instances + inst) * rows;
  if (a.mode == kOutNtt) {
    uint32_t* out = static_cast<uint32_t*>(a.out);
    for (int i = 0; i < nown; ++i) {
      uint4* dst = reinterpret_cast<uint4*>(out + ((out_row0 + own(i)) * n + col) * 2 * kN);
      const uint4* srcv = reinterpret_cast<const uint4*>(v_int + own(i) * 2 * kN);
      for (int w = tid; w < 2 * kN / 4; w += nthreads) dst[w] = srcv[w];
    }
  } else {
    // out_raw / out_words: the block's rows in rounds of P, a pair a row's
    // inverse; then the whole block composes (and rescales and bit-packs)
    // the round's rows
    const int q2b = static_cast<int>(a.enc.bits[0]);
    const int q1b = static_cast<int>(a.enc.bits[1]);
    const long long inst_base = static_cast<long long>(query) * a.num_words +
                                static_cast<long long>(inst) *
                                    (n * 64 * q2b + n * n * 64 * q1b);
    for (int i0 = 0; i0 < nown; i0 += P) {
      const int nr = min(P, nown - i0);
      if (p < nr) {
        uint32_t v[kPer];
#pragma unroll
        for (int h = 0; h < kPer / 4; ++h) {
          const uint4 u = reinterpret_cast<const uint4*>(
              v_int + (own(i0 + p) * 2 + c) * kN + lc_base(j))[h];
          v[4 * h] = u.x; v[4 * h + 1] = u.y; v[4 * h + 2] = u.z; v[4 * h + 3] = u.w;
        }
        inverse(v, buf_a, buf_b, j, 1 + g, tbl, q);
#pragma unroll
        for (int i = 0; i < kPer; ++i) v[i] = sdk::ntt_canonical(v[i], q);
        to_smem<0>(buf_a, j, v);
      }
      __syncthreads();
      // row own(i0 + rr): channel 0's residues in group 2 rr's buffer A,
      // channel 1's in group 2 rr + 1's; its rescaled values staged in
      // group 2 rr's buffer B (after the inverse's last reads of it)
      for (int it = tid; it < nr * kN; it += nthreads) {
        const int rr = it / kN;
        const int x = it % kN;
        const int row = own(i0 + rr);
        const uint32_t x0 = smem[4 * rr * kPad + pad(x)];
        const uint32_t x1 = smem[(4 * rr + 2) * kPad + pad(x)];
        const uint64_t val = sdk::compose(x0, x1, a.enc);
        if (a.mode == kOutRaw) {
          static_cast<int64_t*>(a.out)[((out_row0 + row) * n + col) * kN + x] =
              static_cast<int64_t>(val);
        } else {
          smem[(4 * rr + 1) * kPad + x] = sdk::rescale(
              x0, x1, static_cast<uint32_t>(val), row == 0 ? 0 : 1, a.enc);
        }
      }
      if (a.mode == kOutWords) {
        __syncthreads();
        // the round's rows' words: row 0 has 64 q2_bits, the others 64
        // q1_bits (only a round's first row can be row 0)
        const int first = 64 * (own(i0) == 0 ? q2b : q1b);
        for (int w = tid; w < first + (nr - 1) * 64 * q1b; w += nthreads) {
          const int rr = w < first ? 0 : 1 + (w - first) / (64 * q1b);
          const int lw = w < first ? w : (w - first) % (64 * q1b);
          const int row = own(i0 + rr);
          const int b = row == 0 ? q2b : q1b;
          const uint32_t* stage = smem + (4 * rr + 1) * kPad;
          // bits 32 lw .. 32 lw + 31 of the row's LSB-first b-bit values
          const int bit = 32 * lw;
          int i = bit / b;
          int filled = b - bit % b;
          uint32_t word = stage[i] >> (bit % b);
          while (filled < 32) {
            word |= stage[++i] << filled;
            filled += b;
          }
          static_cast<uint32_t*>(a.out)[
              inst_base + (row == 0 ? col * 64 * q2b
                                    : n * 64 * q2b + ((row - 1) * n + col) * 64 * q1b) +
              lw] = word;
        }
      }
      __syncthreads();             // the next round's inverses rewrite buf_a / buf_b
    }
  }
  if (cs > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Lets the kernel use up to kMaxSmem of dynamic shared memory, once a device.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(pack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

size_t smem_bytes(int n, int version, int pairs) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(4 * pairs) * kPad +
          static_cast<size_t>(n + 1 + (version == 0 ? 0 : 2)) * 2 * kN);
}

}  // namespace

// v_ct: (nq, instances, n*n, 2, 1, z) int64 raw values mod Q, z = 2048.
// keys: device table of nq * nkeys pointers (nkeys = n for version 0:
// v_packing[r]; 2 for version 1: w_key, w_shift), each to a (n+1, t_conv,
// 2, z) uint32 NTT matrix. tables: (2, 4, z). mode 0: out (nq, instances,
// n+1, n, 2, z) uint32 NTT residues; 1: out (nq, instances, n+1, n, z)
// int64 raw values; 2: out (nq, num_words) uint32 response words, the
// encode's constants as ResponseEncodePlan's (q2 / q1 values and widths, Q
// and Q^{-1} mod 2^32). pairs: transform-group pairs a block (1..4);
// cluster: blocks a (query, instance, column), 1 or n (up to 8).
extern "C" int sdk_pack(const void* v_ct, const void* keys, const void* tables,
                        void* out, int mode, int nq, int instances, int n,
                        int t_conv, int bits_per, int version, int pairs,
                        int cluster, unsigned int q0, unsigned int q1,
                        unsigned long long inv_q0_mod_q1, long long num_words,
                        unsigned long long modulus, unsigned int qinv,
                        unsigned int q2_val, unsigned int q1_val,
                        unsigned int q2_bits, unsigned int q1_bits,
                        void* stream) {
  const long long blocks =
      static_cast<long long>(nq) * instances * n * cluster;
  const size_t smem = smem_bytes(n, version, pairs);
  if (mode < kOutNtt || mode > kOutWords || pairs < 1 || pairs > kMaxPairs ||
      (cluster != 1 && cluster != n) || cluster > 8 || n < 1 ||
      t_conv < 1 || smem > static_cast<size_t>(kMaxSmem) ||
      blocks > 0x7FFFFFFFLL || q2_bits > 32 || q1_bits > 32 ||
      (mode == kOutWords && q2_bits * q1_bits == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  PackArgs a;
  a.v_ct = static_cast<const int64_t*>(v_ct);
  a.keys = static_cast<const uint32_t* const*>(keys);
  a.tables = static_cast<const uint32_t*>(tables);
  a.out = out;
  a.mode = mode;
  a.instances = instances;
  a.n = n;
  a.t_conv = t_conv;
  a.bits_per = bits_per;
  a.version = version;
  a.pairs = pairs;
  a.cluster = cluster;
  a.q0 = q0;
  a.q1 = q1;
  a.num_words = num_words;
  for (int ch = 0; ch < 2; ++ch) {
    const uint32_t qc = ch ? q1 : q0;
    const uint32_t r32 = static_cast<uint32_t>((1ull << 32) % qc);
    a.red[ch] = Reducer{qc, r32, sdk::shoup_word(r32, qc),
                        static_cast<uint32_t>((1ull << 32) / qc)};
  }
  a.enc = sdk::make_encode_consts(q0, q1, static_cast<uint32_t>(inv_q0_mod_q1),
                                  modulus, qinv, q2_val, q1_val, q2_bits,
                                  q1_bits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(2 * kGroup * pairs);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, pack_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of G an SM can hold at this shape and tiling
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on an error.
extern "C" int sdk_pack_occupancy(int n, int version, int pairs) {
  int blocks = 0;
  cudaError_t err = allow_smem();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pack_kernel, 2 * kGroup * pairs,
        smem_bytes(n, version, pairs));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
