// Negacyclic NTT butterflies over 2048-point polynomials, shared by ntt.cu
// and the fused kernels (fold_round.cu, expansion.cu, pack.cu, ingest.cu):
// the transform core (namespace sdk::core, below). A 2048-point transform
// is owned by a group of 128 threads that hold 16 coefficients each in
// registers and run three passes of 3, 4 and 4 stages (radix 2^3, 2^4, 2^4)
// with two exchanges through a padded shared buffer between them, so a
// transform has two barriers of its group. The passes' index maps and
// twiddle indices are mirrored by sdk_tpu_torch/ops/ntt.py (CORE_PASSES,
// core_index, core_pad, core_twiddle), which
// tests/test_torch_ntt_fold_schedule.py emulates.
//
// Arithmetic: the Harvey butterflies of the reference (ntt_host.py:20-77)
// with Shoup-scaled twiddles from params.ntt_tables, in wrapping uint32:
// w*y - mulhi(y, w')*q is exact because the true difference is < 2q < 2^30.
// Twiddles are indexed [m : 2m] per stage and the output is in ntt_host
// order; the inverse's halving step (x + q*(t&1)) >> 1 carries the 1/n. Any
// grouping of these exact butterflies gives the same canonical words.
//
// tables: (2, 4, n) uint32 = per channel (w, w', w_inv, w_inv').

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sdk {

// Any uint32 -> a valid forward-NTT input (< 4q): the lazy butterflies take
// [0, 4q), everything above is reduced mod q first.
__device__ __forceinline__ uint32_t ntt_input(uint32_t v, uint32_t q) {
  if (v >= 4u * q) v %= q;   // rare: a branch, not a select over a division
  return v;
}

// A lazy value in [0, 4q) -> its canonical residue in [0, q).
__device__ __forceinline__ uint32_t ntt_canonical(uint32_t v, uint32_t q) {
  const uint32_t two_q = 2u * q;
  v = v >= two_q ? v - two_q : v;
  return v >= q ? v - q : v;
}

// ---------------------------------------------------------------------------
// The transform core: 128 threads a polynomial, 16 coefficients a thread.
//
// A pass of S stages works on units of 2^S coefficients x = base + t_lo * i
// (i < 2^S) that no butterfly of the pass leaves; a thread holds U = 16 / 2^S
// units, v[i * U + u] being coefficient i of unit u. The forward transform
// (strides t = 1024 .. 1) and the inverse (t = 1 .. 1024) run
//   pass a: t = 1024, 512, 256   (S 3, t_lo 256)  layout La
//   pass b: t = 128, 64, 32, 16  (S 4, t_lo 16)   layout Lb
//   pass c: t = 8, 4, 2, 1       (S 4, t_lo 1)    layout Lc
// (the forward a, b, c; the inverse c, b, a) where thread j of the group
// holds, as v[i],
//   La: x = 2j + (i & 1) + 256 (i >> 1)    (16-byte loads of int64 pairs)
//   Lb: x = 256 (j >> 4) + (j & 15) + 16 i
//   Lc: x = 16 j + i                       (16-byte loads and stores)
// A unit's butterflies at stride t use twiddle m + g with m = n / 2t and g =
// x / 2t; for the units of a thread that is (m_unit + G) * 2^s + (i >> (S -
// s)) in stage s of the pass (t = t_lo * 2^(S-1-s)), where m_unit = n / (t_lo
// * 2^S) and G = base / (t_lo * 2^S): G = 0 in pass a, j >> 4 in b, j in c. So
// a stage's 2^s twiddles are consecutive words, read with one or two vector
// loads a pass-stage, never one a butterfly.
//
// Exchanges go through a buffer of kPad words, word x at pad(x) = x + (x >>
// 5): each layout is base(j) + off(i) with disjoint bits, so pad(base) +
// pad(off) addresses it and off's part is an immediate. Banks: La, Lc and
// the 16-byte staging of ntt.cu are conflict-free, Lb 2-way. A transform
// writes buffer A, barrier, reads A, writes buffer B, barrier, reads B, so
// back-to-back transforms on the same two buffers need no third barrier.
// The barriers are the group's own (group_sync): every thread of a group
// calls the core the same number of times.
namespace core {

constexpr int kLogN = 11;
constexpr int kN = 1 << kLogN;
constexpr int kGroup = 128;              // threads a polynomial
constexpr int kPer = 16;                 // coefficients a thread
constexpr int kPad = kN + (kN >> 5);     // words of an exchange buffer

__host__ __device__ constexpr int pad(int x) { return x + (x >> 5); }

// layout bases (thread j) and offsets (coefficient i), unpadded
__device__ __forceinline__ int la_base(int j) { return 2 * j; }
__host__ __device__ constexpr int la_off(int i) { return (i & 1) + 256 * (i >> 1); }
__device__ __forceinline__ int lb_base(int j) { return ((j >> 4) << 8) + (j & 15); }
__host__ __device__ constexpr int lb_off(int i) { return 16 * i; }
__device__ __forceinline__ int lc_base(int j) { return 16 * j; }

template <int kLayout>   // 0: La, 1: Lb, 2: Lc
__device__ __forceinline__ void to_smem(uint32_t* buf, int j,
                                        const uint32_t (&v)[kPer]) {
  const int b = pad(kLayout == 0 ? la_base(j) : kLayout == 1 ? lb_base(j)
                                                             : lc_base(j));
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    buf[b + pad(kLayout == 0 ? la_off(i) : kLayout == 1 ? lb_off(i) : i)] = v[i];
}

template <int kLayout>
__device__ __forceinline__ void from_smem(const uint32_t* buf, int j,
                                          uint32_t (&v)[kPer]) {
  const int b = pad(kLayout == 0 ? la_base(j) : kLayout == 1 ? lb_base(j)
                                                             : lc_base(j));
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    v[i] = buf[b + pad(kLayout == 0 ? la_off(i) : kLayout == 1 ? lb_off(i) : i)];
}

// nt consecutive twiddles from word offset off (aligned to nt words) of a
// table in device memory (read-only path) or in shared memory
template <int nt>
__device__ __forceinline__ void load_tw(const uint32_t* __restrict__ t,
                                        int off, uint32_t (&o)[nt]) {
  if constexpr (nt == 1) {
    o[0] = t[off];
  } else if constexpr (nt == 2) {
    const uint2 a = *reinterpret_cast<const uint2*>(t + off);
    o[0] = a.x; o[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < nt / 4; ++h) {
      const uint4 a = reinterpret_cast<const uint4*>(t + off)[h];
      o[4 * h] = a.x; o[4 * h + 1] = a.y; o[4 * h + 2] = a.z; o[4 * h + 3] = a.w;
    }
  }
}

// Harvey forward butterfly: x, y < 4q -> x + wy, x - wy lazy in [0, 4q)
__device__ __forceinline__ void bfly_fwd(uint32_t& x, uint32_t& y, uint32_t w,
                                         uint32_t wp, uint32_t q,
                                         uint32_t two_q) {
  const uint32_t cx = min(x, x - two_q);      // x < 2q ? x : x - 2q
  const uint32_t qn = w * y - __umulhi(y, wp) * q;
  x = cx + qn;
  y = cx + (two_q - qn);
}

// Harvey inverse butterfly: x, y < 2q -> (x + y) / 2, (x - y) w lazy in [0, 2q)
__device__ __forceinline__ void bfly_inv(uint32_t& x, uint32_t& y, uint32_t w,
                                         uint32_t wp, uint32_t q,
                                         uint32_t two_q) {
  const uint32_t t = two_q - y + x;
  const uint32_t cx = x + y - ((x << 1) >= t ? two_q : 0u);
  x = (cx + q * (t & 1u)) >> 1;
  y = w * t - __umulhi(t, wp) * q;
}

// Stage s of a pass of S stages over the thread's 16 / 2^S units (all with
// unit group G, tw_base = m_unit + G); w, wp: the channel's (w, w') or
// (w_inv, w_inv') tables.
template <int S, int s, bool kInverse>
__device__ __forceinline__ void stage(uint32_t (&v)[kPer],
                                      const uint32_t* __restrict__ w,
                                      const uint32_t* __restrict__ wp,
                                      int tw_base, uint32_t q) {
  constexpr int U = kPer >> S;
  constexpr int half = 1 << (S - 1 - s);
  const uint32_t two_q = 2u * q;
  uint32_t tw[1 << s], twp[1 << s];
  load_tw<(1 << s)>(w, tw_base << s, tw);
  load_tw<(1 << s)>(wp, tw_base << s, twp);
#pragma unroll
  for (int i = 0; i < (1 << S); ++i) {
    if (i & half) continue;
    const int g = i >> (S - s);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (kInverse) {
        bfly_inv(v[i * U + u], v[(i + half) * U + u], tw[g], twp[g], q, two_q);
      } else {
        bfly_fwd(v[i * U + u], v[(i + half) * U + u], tw[g], twp[g], q, two_q);
      }
    }
  }
}

// The S stages of a pass: s = 0 .. S-1 forward (strides falling), S-1 .. 0
// inverse (strides rising).
template <int S, bool kInverse, int ss = 0>
__device__ __forceinline__ void pass(uint32_t (&v)[kPer],
                                     const uint32_t* __restrict__ w,
                                     const uint32_t* __restrict__ wp,
                                     int m_unit, int G, uint32_t q) {
  if constexpr (ss < S) {
    stage<S, kInverse ? S - 1 - ss : ss, kInverse>(v, w, wp, m_unit + G, q);
    pass<S, kInverse, ss + 1>(v, w, wp, m_unit, G, q);
  }
}

// Barrier of the 128 threads of one group: named barrier bar_id >= 1, so
// the groups of a block do not wait for each other, or the block's barrier
// (bar_id 0) where the block is one group.
__device__ __forceinline__ void group_sync(int bar_id) {
  if (bar_id == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(kGroup) : "memory");
  }
}

// Forward transform of the group's polynomial from La (inputs < 4q) to Lc
// (outputs lazy in [0, 4q)); tbl: the channel's (w, w', ...) rows, in
// device or shared memory.
__device__ __forceinline__ void forward(uint32_t (&v)[kPer], uint32_t* buf_a,
                                        uint32_t* buf_b, int j, int bar_id,
                                        const uint32_t* __restrict__ tbl,
                                        uint32_t q) {
  const uint32_t* w = tbl;
  const uint32_t* wp = tbl + kN;
  pass<3, false>(v, w, wp, 1, 0, q);
  to_smem<0>(buf_a, j, v);
  group_sync(bar_id);
  from_smem<1>(buf_a, j, v);
  pass<4, false>(v, w, wp, 8, j >> 4, q);
  to_smem<1>(buf_b, j, v);
  group_sync(bar_id);
  from_smem<2>(buf_b, j, v);
  pass<4, false>(v, w, wp, 128, j, q);
}

// Inverse transform from Lc (inputs < 2q) to La (outputs lazy in [0, 2q)).
__device__ __forceinline__ void inverse(uint32_t (&v)[kPer], uint32_t* buf_a,
                                        uint32_t* buf_b, int j, int bar_id,
                                        const uint32_t* __restrict__ tbl,
                                        uint32_t q) {
  const uint32_t* w = tbl + 2 * kN;
  const uint32_t* wp = tbl + 3 * kN;
  pass<4, true>(v, w, wp, 128, j, q);
  to_smem<2>(buf_a, j, v);
  group_sync(bar_id);
  from_smem<1>(buf_a, j, v);
  pass<4, true>(v, w, wp, 8, j >> 4, q);
  to_smem<1>(buf_b, j, v);
  group_sync(bar_id);
  from_smem<0>(buf_b, j, v);
  pass<3, true>(v, w, wp, 1, 0, q);
}

}  // namespace core

// Barrett reduction of any 64-bit x mod q (q < 2^31, not a power of two)
// with mu = floor((2^64 - 1) / q) = floor(2^64 / q): the estimated quotient
// umul64hi(x, mu) is the true one or one less, so x - quot*q lies in
// [0, 2q). A dozen instructions where the compiler's 64-bit `%` is a
// subroutine of more than a hundred.
__device__ __forceinline__ uint64_t barrett_mu(uint32_t q) {
  return ~0ull / q;
}

__device__ __forceinline__ uint32_t barrett_reduce(uint64_t x, uint32_t q,
                                                   uint64_t mu) {
  const uint64_t r = x - __umul64hi(x, mu) * q;
  return static_cast<uint32_t>(r >= q ? r - q : r);
}

// Garner: residues (x0 mod q0, x1 mod q1) -> the value in [0, q0*q1)
// (params.crt_compose_2); mu1 = barrett_mu(q1).
__device__ __forceinline__ uint64_t crt_compose(uint32_t x0, uint32_t x1,
                                                uint32_t q0, uint32_t q1,
                                                uint64_t inv_q0_mod_q1,
                                                uint64_t mu1) {
  const uint32_t d = barrett_reduce(x1 + q1 - barrett_reduce(x0, q1, mu1), q1,
                                    mu1);
  const uint64_t t = barrett_reduce(d * inv_q0_mod_q1, q1, mu1);
  return x0 + static_cast<uint64_t>(q0) * t;
}

// Digit k of the base-2^bits_per decomposition of v (gadget_digits): zero
// once the offset passes 64 bits, at most 32 bits wide.
__device__ __forceinline__ uint32_t gadget_digit(uint64_t v, int k,
                                                 int bits_per) {
  const int off = k * bits_per;
  const uint64_t mask = bits_per >= 32 ? 0xFFFFFFFFull
                                       : (1ull << bits_per) - 1;
  return off >= 64 ? 0u : static_cast<uint32_t>((v >> off) & mask);
}

}  // namespace sdk
