"""A CPU model of the transform core (csrc/ntt_device.cuh, sdk::core) and of
kernels A / A' (csrc/ntt.cu) and F (csrc/fold_round.cu) built on it, in
numpy.

The kernels run only on the card (tests/test_torch_kernels_gpu.py); here
their thread arithmetic is replayed without them: the passes' index maps
(``ntt.core_index``) keep every butterfly inside a thread, the twiddle
indices the kernel computes (``ntt.core_twiddle``) are the reference's m + x
/ 2t, the exchanges hit distinct banks, an emulation of the passes with the
same lazy Harvey butterflies in wrapping 32-bit arithmetic equals
``ntt_forward_plain`` / ``ntt_inverse_plain`` word for word (any uint32
input included), F's split of a slot's digit polynomials over a cluster with
its mod-q partial sums equals ``fold_round_plain``, and every tiling the
wrappers can pick stores each output word once. No JAX.
"""

import numpy as np
import pytest
import torch

from sdk_tpu_torch.ops import ntt, spiral as sj
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json)

PARAMS = get_fast_expansion_testing_params()
# version-1 crypto shapes of the 1 GiB bucket (t_gsw 7, t_conv 3)
V1_TINY = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 2,'
    ' "version": 1}')
N = 1 << ntt.CORE_LOG_N
J = np.arange(ntt.CORE_GROUP)[:, None]          # thread of a group
I = np.arange(ntt.CORE_PER)[None, :]            # v[i] of a thread
M32 = np.uint64(0xFFFFFFFF)
LAYOUTS = ("a", "b", "c")


def u32_tables(params):
    """(crt, 4, n) uint64 of the (w, w', w_inv, w_inv') bit patterns."""
    return ntt.tables(params, "cpu").numpy().view(np.uint32).astype(np.uint64)


def index_map(layout):
    return ntt.core_index(layout, J, I)                # (128, 16)


# ---------------------------------------------------------------------------
# index maps, twiddles and banks

@pytest.mark.parametrize("layout", LAYOUTS)
def test_layouts_are_permutations(layout):
    x = index_map(layout)
    assert sorted(x.ravel().tolist()) == list(range(N))


def _pass_butterflies(layout, S, t_lo):
    """(s, lower v index, upper v index) of every butterfly of a pass."""
    units = ntt.CORE_PER >> S
    out = []
    for s in range(S):
        half = 1 << (S - 1 - s)
        for ii in range(1 << S):
            if ii & half:
                continue
            for u in range(units):
                out.append((s, ii * units + u, (ii + half) * units + u))
    return out


@pytest.mark.parametrize("p", range(3))
def test_pass_butterflies_stay_in_a_thread_and_use_the_reference_twiddles(p):
    layout, S, t_lo = ntt.CORE_PASSES[p]
    x = index_map(layout)
    seen = set()
    for s, lo, hi in _pass_butterflies(layout, S, t_lo):
        t = t_lo << (S - 1 - s)
        assert np.all(x[:, hi] == x[:, lo] + t)
        assert np.all((x[:, lo] // t) % 2 == 0)       # lower element of a pair
        want = N // (2 * t) + x[:, lo] // (2 * t)
        got = ntt.core_twiddle(layout, S, t_lo, J[:, 0], s, lo)
        assert np.array_equal(got, want)
        seen.update((t, int(v)) for v in x[:, lo])
    # every butterfly of the pass's stages, once
    assert len(seen) == S * N // 2


def test_passes_cover_every_stage_once():
    strides = [t_lo << (S - 1 - s) for _, S, t_lo in ntt.CORE_PASSES
               for s in range(S)]
    assert strides == [1 << k for k in reversed(range(ntt.CORE_LOG_N))]
    assert sum(S for _, S, _ in ntt.CORE_PASSES) == ntt.CORE_LOG_N


def test_stage_twiddles_are_aligned_vector_loads():
    """A pass-stage's 2^s twiddles of a thread are consecutive words from
    an offset aligned to 2^s words (one scalar, 8-byte or 16-byte load)."""
    for layout, S, t_lo in ntt.CORE_PASSES:
        for s in range(S):
            idx = np.stack([ntt.core_twiddle(layout, S, t_lo, J[:, 0], s, i)
                            for i in range(ntt.CORE_PER)], axis=1)
            first = idx.min(axis=1)
            assert np.all(first % (1 << s) == 0)
            for row, f in zip(idx, first):
                assert set(row.tolist()) == set(range(f, f + (1 << s)))


def _banks(addr):
    """Most words one bank serves in one warp access, over all accesses:
    addr (128 threads, accesses)."""
    worst = 0
    for w in range(ntt.CORE_GROUP // 32):
        for a in addr[32 * w:32 * w + 32].T:
            worst = max(worst, np.bincount(a % 32, minlength=32).max())
    return worst


@pytest.mark.parametrize("layout,ways", [("a", 1), ("b", 2), ("c", 1)])
def test_exchanges_bank_spread(layout, ways):
    assert _banks(ntt.core_pad(index_map(layout))) == ways


def test_staging_of_16_byte_loads_is_conflict_free():
    """ntt.cu's forward loads words 4j + 512r .. +3 and stores each word to
    its padded place: 32 distinct banks a store."""
    r, e = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    x = 4 * J + (512 * r + e).ravel()[None, :]
    assert sorted(x.ravel().tolist()) == list(range(N))
    assert _banks(ntt.core_pad(x)) == 1


def test_padding_is_additive_over_base_and_offset():
    """The kernel addresses pad(base(j)) + pad(off(i)): the two parts have
    disjoint bits in every layout."""
    for layout in LAYOUTS:
        base = ntt.core_index(layout, J, 0 * I)
        off = ntt.core_index(layout, 0 * J, I)
        assert np.all((base & off) == 0)
        assert np.array_equal(ntt.core_pad(base + off),
                              ntt.core_pad(base) + ntt.core_pad(off))
    assert ntt.core_pad(N - 1) < N + N // 32            # kPad words


# ---------------------------------------------------------------------------
# the passes, emulated

def _bfly_fwd(x, y, w, wp, q):
    two_q = 2 * q
    cx = np.where(x >= two_q, x - two_q, x)
    qn = (w * y - ((y * wp) >> np.uint64(32)) * q) & M32
    return (cx + qn) & M32, (cx + two_q - qn) & M32


def _bfly_inv(x, y, w, wp, q):
    two_q = 2 * q
    t = (two_q - y + x) & M32
    cx = (x + y - np.where(((x << np.uint64(1)) & M32) >= t, two_q, 0)) & M32
    x2 = ((cx + q * (t & np.uint64(1))) & M32) >> np.uint64(1)
    y2 = (w * t - ((t * wp) >> np.uint64(32)) * q) & M32
    return x2, y2


def _run_pass(v, layout, S, t_lo, w, wp, q, inverse):
    """v: (polys, 128, 16) uint64 in the pass's layout; w, wp: (polys, n)."""
    bfs = _pass_butterflies(layout, S, t_lo)
    order = sorted(set(s for s, _, _ in bfs), reverse=inverse)
    for s in order:
        for s_, lo, hi in bfs:
            if s_ != s:
                continue
            tw = ntt.core_twiddle(layout, S, t_lo, J[:, 0], s, lo)  # (128,)
            f = _bfly_inv if inverse else _bfly_fwd
            v[:, :, lo], v[:, :, hi] = f(v[:, :, lo], v[:, :, hi], w[:, tw],
                                          wp[:, tw], q)
    return v


def _exchange(v, src, dst):
    """Write v in layout src to a padded buffer, read it back in dst."""
    buf = np.zeros(v.shape[:1] + (ntt.core_pad(N - 1) + 1,), np.uint64)
    buf[:, ntt.core_pad(index_map(src))] = v
    return buf[:, ntt.core_pad(index_map(dst))]


def core_transform(params, x, chans, inverse):
    """The core's transform of polynomials x (polys, n) uint64 in CRT
    channels chans (polys,): forward from La (lazy < 4q) to Lc, inverse from
    Lc (< 2q) to La; returns (polys, 128, 16) lazy values in the output
    layout."""
    tb = u32_tables(params)[chans]                  # (polys, 4, n)
    q = np.array(params.moduli, np.uint64)[chans][:, None]
    w, wp = (tb[:, 2], tb[:, 3]) if inverse else (tb[:, 0], tb[:, 1])
    passes = ntt.CORE_PASSES[::-1] if inverse else ntt.CORE_PASSES
    v = x[:, index_map(passes[0][0])].copy()
    for k, (layout, S, t_lo) in enumerate(passes):
        if k:
            v = _exchange(v, passes[k - 1][0], layout)
        v = _run_pass(v, layout, S, t_lo, w, wp, q, inverse)
    return v


def canonical_out(params, v, chans, layout):
    q = np.array(params.moduli, np.uint64)[chans][:, None, None]
    v = np.where(v >= 2 * q, v - 2 * q, v)
    v = np.where(v >= q, v - q, v)
    out = np.zeros((v.shape[0], N), np.uint64)
    out[:, index_map(layout)] = v
    return out


def emulate_ntt(params, x, inverse):
    """Kernel A / A' on (polys, 2, n) int32 bit patterns, as ntt.cu runs it:
    the forward reduces inputs >= 4q on load."""
    flat = x.reshape(-1, N).astype(np.uint32).astype(np.uint64)
    chans = np.arange(flat.shape[0]) & 1
    q = np.array(params.moduli, np.uint64)[chans][:, None]
    if not inverse:
        flat = np.where(flat >= 4 * q, flat % q, flat)
    v = core_transform(params, flat, chans, inverse)
    out = canonical_out(params, v, chans, "a" if inverse else "c")
    return out.astype(np.uint32).view(np.int32).reshape(x.shape)


def _residues(rng, params, lead):
    return np.stack([rng.integers(0, q, lead + (N,)) for q in params.moduli],
                    axis=-2).astype(np.int32)


@pytest.mark.parametrize("params", [PARAMS, V1_TINY], ids=["v0", "v1"])
def test_core_emulation_matches_plain(params):
    rng = np.random.default_rng(41)
    x = _residues(rng, params, (5,))
    digits = rng.integers(0, 1 << 19, (3, 2, N)).astype(np.int32)
    for inp in (x, digits):
        want = ntt.ntt_forward_plain(params, torch.from_numpy(inp)).numpy()
        assert np.array_equal(emulate_ntt(params, inp, False), want)
    want = ntt.ntt_inverse_plain(params, torch.from_numpy(x)).numpy()
    assert np.array_equal(emulate_ntt(params, x, True), want)


def test_core_emulation_takes_any_u32():
    """Inputs over the whole uint32 range, the extremes planted."""
    rng = np.random.default_rng(42)
    x = rng.integers(0, 1 << 32, (3, 2, N), dtype=np.uint64)
    q0, q1 = PARAMS.moduli
    x[0, :, :6] = [0, 4 * q0 - 1, 4 * q0, 4 * q1, 1 << 31, (1 << 32) - 1]
    x[1] = (1 << 32) - 1
    inp = x.astype(np.uint32).view(np.int32)
    want = ntt.ntt_forward_plain(PARAMS, torch.from_numpy(inp)).numpy()
    assert np.array_equal(emulate_ntt(PARAMS, inp, False), want)


def test_core_lazy_ranges_stay_in_32_bits():
    """Forward values stay < 4q and inverse values < 2q after every pass, at
    the worst inputs (4q - 1 forward, 2q - 1 inverse)."""
    for inverse, bound, fill in ((False, 4, 4), (True, 2, 2)):
        x = np.stack([np.full(N, fill * q - 1, np.uint64)
                      for q in PARAMS.moduli])
        chans = np.arange(2)
        v = core_transform(PARAMS, x, chans, inverse)
        q = np.array(PARAMS.moduli, np.uint64)[:, None, None]
        assert np.all(v < bound * q) and np.all(v < (1 << 32))


# ---------------------------------------------------------------------------
# kernel F: the digit split over a cluster

def emulate_fold_slot(params, a, b, v_neg, v_fold, cluster):
    """One slot of kernel F at a cluster size: a, b (2, n) int64 raw; keys
    (2, ell, 2, n) int32. Returns the (2, n) int64 output."""
    if not a.any():
        return b.copy()
    if not b.any():
        return a.copy()
    t_gsw = params.t_gsw
    ell = 2 * t_gsw
    bits = sj._get_bits_per(params, t_gsw)
    q = np.array(params.moduli, np.uint64)
    chans = np.arange(2)
    keys = [v_neg.astype(np.uint64), v_fold.astype(np.uint64)]
    lc = index_map("c")
    partials = []
    for digits in sj.fold_digit_split(t_gsw, cluster):
        acc = np.zeros((2, 2, N), np.uint64)          # (channel, row, x)
        for d in digits:
            which, r, k = d // ell, (d // t_gsw) & 1, d % t_gsw
            raw = (b if which else a)[r].astype(np.uint64)
            dig = (raw >> np.uint64(k * bits)) & np.uint64((1 << bits) - 1)
            y = np.zeros((2, N), np.uint64)
            y[:, lc] = core_transform(params, np.stack([dig, dig]), chans,
                                      False)          # lazy < 4q, Lc
            for row in range(2):
                acc[:, row] += y * keys[which][row, 2 * k + r]
        partials.append(acc % q[:, None, None])
    red = sum(partials) % q[:, None, None]            # block 0's sum
    out = np.zeros((2, 2, N), np.uint64)
    for row in range(2):
        v = core_transform(params, red[:, row], chans, True)
        out[:, row] = canonical_out(params, v, chans, "a")
    x0, x1 = out[0].astype(np.int64), out[1].astype(np.int64)
    q0, q1 = params.moduli
    t = (x1 - x0 % q1) % q1 * params.inv_q0_mod_q1 % q1
    return x0 + q0 * t


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_fold_cluster_split_matches_plain(cluster):
    params = V1_TINY
    rng = np.random.default_rng(43 + cluster)
    ell = 2 * params.t_gsw
    v_neg = _residues(rng, params, (2, ell))
    v_fold = _residues(rng, params, (2, ell))
    cts = rng.integers(0, params.modulus, (4, 2, 1, N), dtype=np.int64)
    cts[1, 0, 0, :3] = [0, params.modulus - 1, 1]
    cts[3, 1, 0, -1] = params.modulus - 1
    want = sj.fold_round_plain(params, torch.from_numpy(cts)[None],
                               torch.from_numpy(v_neg),
                               torch.from_numpy(v_fold))[0].numpy()
    for s in range(2):
        got = emulate_fold_slot(params, cts[s, :, 0], cts[s + 2, :, 0],
                                v_neg, v_fold, cluster)
        assert np.array_equal(got, want[s, :, 0])


def test_fold_zero_slots_verbatim():
    params = V1_TINY
    rng = np.random.default_rng(47)
    ell = 2 * params.t_gsw
    v_neg, v_fold = _residues(rng, params, (2, ell)), _residues(rng, params, (2, ell))
    a = rng.integers(0, params.modulus, (2, N), dtype=np.int64)
    z = np.zeros_like(a)
    for cluster in (1, 4):
        assert np.array_equal(emulate_fold_slot(params, z, a, v_neg, v_fold,
                                                cluster), a)
        assert np.array_equal(emulate_fold_slot(params, a, z, v_neg, v_fold,
                                                cluster), a)
        assert not emulate_fold_slot(params, z, z, v_neg, v_fold,
                                     cluster).any()


def test_fold_accumulators_stay_in_64_bits():
    """4 t_gsw products of a lazy transform output (< 4q) and a key word
    (< q) fit a uint64 for t_gsw <= 15; a cluster's 4 partials (< q each)
    fit 31 bits."""
    q = max(PARAMS.moduli)
    assert 4 * 15 * (4 * q - 1) * (q - 1) < 1 << 64
    assert 4 * (q - 1) < 1 << 31


# ---------------------------------------------------------------------------
# tilings: every output word stored once

@pytest.mark.parametrize("layout,width", [("c", 4), ("a", 2)])
def test_ntt_stores_each_word_once_in_whole_vectors(layout, width):
    """A stores Lc as 16-byte vectors, A' stores La as int32 pairs: a
    thread's words come in aligned runs of the vector's width, and the
    group's stores cover the polynomial once (one polynomial a block)."""
    x = index_map(layout)
    assert np.all(x[:, ::width] % width == 0)
    for k in range(1, width):
        assert np.array_equal(x[:, k::width], x[:, ::width] + k)
    assert np.array_equal(np.bincount(x.ravel(), minlength=N), np.ones(N))


def fold_round_slots(params, nq):
    """Output slots of each round of a fold at nq queries."""
    it = params.instances * params.n * params.n
    return [nq * it * (1 << (params.db_dim_2 - 1 - r))
            for r in range(params.db_dim_2)]


def replay_fold_blocks(entries, num_per, cluster):
    """Kernel F's block arithmetic (csrc/fold_round.cu: rank, blk, slot,
    entry, a_ptr, b_ptr, o_ptr, in int64 words) for every block of a round
    of ``entries`` x ``num_per`` output slots."""
    ct = 2 * N
    block = np.arange(entries * num_per * cluster)
    rank = block % cluster
    blk = block // cluster
    slot = blk % num_per
    entry = blk // num_per
    a_ptr = (entry * 2 * num_per + slot) * ct
    return rank, entry, slot, a_ptr, a_ptr + num_per * ct, \
        (entry * num_per + slot) * ct


def fold_slot_stores():
    """Words of a slot's output that block 0 stores: on the live path group
    c stores row c at c n + La as int64 pairs (o_row + la_off(2h), + 1), on
    the zero path thread t copies longlong2 t + 256 h (h < 8)."""
    c = np.arange(2)[:, None, None]
    live = c * N + ntt.core_index("a", J[None], I[None])
    t = np.arange(2 * ntt.CORE_GROUP)[:, None] + 256 * np.arange(8)[None, :]
    zero = 2 * t[..., None] + np.arange(2)
    return live.ravel(), zero.ravel()


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_fold_tiling_of_every_round_stores_each_word_once(nq):
    """Every tiling the wrapper can pick, replayed through the kernel's
    block and thread arithmetic at the 1 GiB bucket's rounds: block 0 of
    each cluster owns one output slot and reads that slot's a and b, its
    threads store each word of the slot once, and the cluster's blocks
    split the slot's digit polynomials."""
    from sdk_tpu_torch.params_store import get_params_from_store
    params = get_params_from_store(15, 32768)
    it = params.instances * params.n * params.n
    entries = nq * it
    live, zero = fold_slot_stores()
    for store in (live, zero):
        assert np.array_equal(np.bincount(store, minlength=2 * N),
                              np.ones(2 * N))
    for r in range(params.db_dim_2):
        num_per = 1 << (params.db_dim_2 - 1 - r)
        slots = entries * num_per
        in_shape = (entries, 2 * num_per, 2, 1, N)
        for tl in {sj.fold_tiling(slots, params.t_gsw),
                   *(sj.fold_tiling(slots, params.t_gsw, c)
                     for c in (1, 2, 4))}:
            rank, entry, slot, a_ptr, b_ptr, o_ptr = replay_fold_blocks(
                entries, num_per, tl.cluster)
            # every block of a cluster works on the cluster's slot
            for arr in (entry, slot):
                assert np.all(arr.reshape(-1, tl.cluster)
                              == arr[::tl.cluster, None])
            own = rank == 0
            e, s = entry[own], slot[own]
            assert np.array_equal(o_ptr[own], np.arange(slots) * 2 * N)
            assert np.array_equal(
                a_ptr[own], np.ravel_multi_index((e, s, 0, 0, 0), in_shape))
            assert np.array_equal(b_ptr[own], np.ravel_multi_index(
                (e, s + num_per, 0, 0, 0), in_shape))
            split = sj.fold_digit_split(params.t_gsw, tl.cluster)
            assert [d for rg in split for d in rg] == list(
                range(4 * params.t_gsw))
            assert all(len(rg) for rg in split)


def test_fold_tiling_defaults():
    assert sj.fold_tiling(512, 7) == sj.FoldTiling(1)
    assert sj.fold_tiling(128, 7) == sj.FoldTiling(1)
    assert sj.fold_tiling(64, 7) == sj.FoldTiling(2)
    assert sj.fold_tiling(16, 7) == sj.FoldTiling(4)
    for cluster in (3, 8):
        with pytest.raises(ValueError):
            sj.fold_tiling(16, 7, cluster=cluster)


def test_launches_refuse_cpu_tensors():
    x = torch.zeros((1, 2, N), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt._launch(PARAMS, x, inverse=False)
