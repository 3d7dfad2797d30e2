"""The plain versions of kernels K (int8 DB products) and L (wrapping u32
products, packed forms) against the JAX device programs they replace, run
on the CPU, and the port's wrappers around them. Inputs come from a numpy
seed and include values >= 2^31 and K that is no multiple of 3 or 4.
Integer results: the tolerance is 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import jax_kernels as jk, server_jax as sj
from sdk_tpu_torch import _build
from sdk_tpu_torch.doublepir import kernels as dk, matrix, scheme
from sdk_tpu_torch.doublepir import server_torch as st
from sdk_tpu_torch.doublepir.database import Db
from sdk_tpu_torch.doublepir.params import LOGQ, SEC_PARAM, pick_params
from sdk_tpu_torch.ops.modops import u32_bits

torch.set_num_threads(1)
U32 = np.uint32


def u32(rng, shape, bits=32):
    x = rng.integers(0, 1 << bits, shape, dtype=np.uint64).astype(U32)
    if bits == 32 and x.size:
        x.flat[0] = 0xFFFFFFFF          # always a value >= 2^31
    return x


def t32(x: np.ndarray) -> torch.Tensor:
    return u32_bits(x, "cpu")


def back(t: torch.Tensor) -> np.ndarray:
    return dk.to_numpy_u32(t)


@pytest.mark.parametrize("shape", [(5, 301, 7), (4, 70001, 3), (33, 10, 1)])
def test_matmul_u32_matches_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(41)
    a, b = u32(rng, (M, K)), u32(rng, (K, N))
    want = np.asarray(jax.jit(jk.matmul_u32_traced)(a, b))
    np.testing.assert_array_equal(back(dk.matmul_u32(t32(a), t32(b))), want)
    np.testing.assert_array_equal(dk.matmul_u32_device(a, b, "cpu"), want)
    np.testing.assert_array_equal(want, matrix.matmul_u32(a, b))


def test_packed_forms_match_jax():
    rng = np.random.default_rng(42)
    rows, cols = 32, 11
    ap = matrix.squish(u32(rng, (rows, cols * 3), 10))
    q = u32(rng, (cols * 3, 2))
    want = np.asarray(jax.jit(jk.mat_mul_vec_packed_traced)(ap, q))
    np.testing.assert_array_equal(
        back(dk.mat_mul_vec_packed(t32(ap), t32(q))), want)
    np.testing.assert_array_equal(want, matrix.mat_mul_vec_packed(ap, q))
    bt = u32(rng, (5, cols * 3))
    want = np.asarray(jax.jit(jk.mat_mul_transposed_packed_traced)(ap, bt))
    np.testing.assert_array_equal(
        back(dk.mat_mul_transposed_packed(t32(ap), t32(bt))), want)
    mv, mt = dk.device_kernels("cpu")
    np.testing.assert_array_equal(mt(ap, bt), want)
    np.testing.assert_array_equal(mv(t32(ap), q),
                                  matrix.mat_mul_vec_packed(ap, q))
    un = np.asarray(jk.unsquish_traced(jnp.asarray(ap), cols * 3 - 1))
    np.testing.assert_array_equal(back(dk.unsquish(t32(ap), cols * 3 - 1)), un)


def test_answer_products_match_jax():
    """answer_products (the checklist answer's msg0 and h_2 of one packed
    operand, one launch of L's answer form on a card) on CPU tensors
    equals the JAX packed product of each operand."""
    rng = np.random.default_rng(43)
    ap = matrix.squish(u32(rng, (4, 99), 10))
    b0, b1 = u32(rng, (99, 16)), u32(rng, (99, 3))
    prog = jax.jit(jk.mat_mul_vec_packed_traced)
    got = dk.answer_products(t32(ap), t32(b0), t32(b1))
    for g, b in zip(got, (b0, b1)):
        np.testing.assert_array_equal(back(g), np.asarray(prog(ap, b)))


# csrc/dp_matmul_u32.cu answer_kernel's constants
ANS_THREADS, ANS_CHUNK, ANS_CLUSTER = 256, 512, 4


def emulate_answer(ap: np.ndarray, b0: np.ndarray, b1: np.ndarray,
                   clusters: int):
    """answer_kernel in numpy, block by block: a block's K run of
    ceil(K / blocks) rows, unsquished ANS_CHUNK rows at a time (field k % 3
    of word k / 3); thread t's column quads t + 256 pass of b0 (past N0
    zero), h_2's thread (t % N1, t // N1) over the chunk's rows of its
    phase; each cluster's partials added word by word by the rank whose
    quarter holds the word. Returns the outputs mod 2^32, and checks that
    every row meets each product once and every output word gets one add
    a cluster."""
    M, W = ap.shape
    K, N0, N1 = 3 * W, b0.shape[1], b1.shape[1]
    blocks = clusters * ANS_CLUSTER
    rpb = -(-K // blocks)
    passes = -(-(-(-N0 // 4)) // ANS_THREADS)
    p1 = ANS_THREADS // N1
    mask = np.uint64(0xFFFFFFFF)
    b0w = np.zeros((K, passes * 4 * ANS_THREADS), dtype=np.uint64)
    b0w[:, :N0] = b0
    out0 = np.zeros((M, N0), dtype=np.uint64)
    out1 = np.zeros((M, N1), dtype=np.uint64)
    rows0 = np.zeros(K, dtype=np.int64)
    rows1 = np.zeros(K, dtype=np.int64)
    adds = np.zeros((M, N0), dtype=np.int64)
    for cl in range(clusters):
        parts = np.zeros((ANS_CLUSTER, passes, M, 1024), dtype=np.uint64)
        for rank in range(ANS_CLUSTER):
            k0 = (cl * ANS_CLUSTER + rank) * rpb
            nrows = max(0, min(K - k0, rpb))
            hsum = np.zeros((M, N1), dtype=np.uint64)
            for p in range(passes):
                for i0 in range(0, nrows, ANS_CHUNK):
                    k = np.arange(k0 + i0, k0 + min(nrows, i0 + ANS_CHUNK))
                    words = ap[:, k // 3].astype(np.uint64)
                    a = (words >> (10 * (k % 3)).astype(np.uint64)) & 1023
                    cols = slice(1024 * p, 1024 * (p + 1))
                    parts[rank, p] = (parts[rank, p] + a @ b0w[k, cols]) & mask
                    rows0[k] += p == 0
                    for ph in range(p1 if p == 0 else 0):
                        r = np.arange(ph, len(k), p1)   # thread ph's rows
                        rows1[k[r]] += 1
                        hsum = (hsum + a[:, r] @ b1[k[r]].astype(
                            np.uint64)) & mask
            out1 = (out1 + hsum) & mask
        for p in range(passes):
            words = M * 1024
            for rank in range(ANS_CLUSTER):
                w = np.arange(rank * words // ANS_CLUSTER,
                              (rank + 1) * words // ANS_CLUSTER)
                m, col = w // 1024, 1024 * p + w % 1024
                keep = col < N0
                s = parts[:, p, m[keep], w[keep] % 1024].sum(0) & mask
                out0[m[keep], col[keep]] = (out0[m[keep], col[keep]] + s) & mask
                adds[m[keep], col[keep]] += 1
    assert (rows0 == 1).all() and (rows1 == 1).all()
    assert (adds == clusters).all()
    return out0.astype(U32), out1.astype(U32)


@pytest.mark.parametrize("shape", [(4, 3003, 8, 8, 2), (4, 6003, 1024, 3, 1),
                                   (8, 6003, 1030, 5, 3), (2, 9, 4, 1, 1)])
def test_answer_kernel_model_matches_plain(shape):
    """The numpy model of the answer launch against the two plain packed
    products: K runs that start mid-word and are no multiple of the
    unsquish chunk (3003 rows over 8 blocks: 376 a block; 6003 over 4:
    1,501 in three chunks), N0 = 8 beside 1024 and 1030 (two passes of
    1024 columns, the last quad part past N0), N1 not dividing 256, blocks
    with no rows (9 rows over 4 blocks), and the last packed word's three
    fields at their maximum."""
    M, K, N0, N1, clusters = shape
    rng = np.random.default_rng(44)
    ap = u32(rng, (M, K // 3), 30)
    ap[:, -1] = 1023 | 1023 << 10 | 1023 << 20
    b0, b1 = u32(rng, (K, N0)), u32(rng, (K, N1))
    got = emulate_answer(ap, b0, b1, clusters)
    want = dk.answer_products_plain(t32(ap), t32(b0), t32(b1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, back(w))


@pytest.mark.parametrize("shape", [(7, 1003, 3), (9, 130, 8)])
def test_dot_i8_matches_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(43)
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = u32(rng, (K, N))
    want = np.asarray(jax.jit(sj._dot_i8_u32)(a, b))
    got = st.dot_i8_u32(torch.from_numpy(a), t32(b))
    np.testing.assert_array_equal(back(got), want)
    # the additive row of server_jax.py:248 / :457
    c = 128 - 464 // 2
    want_c = want + (U32(c & 0xFFFFFFFF) * b.sum(axis=0, dtype=U32))[None, :]
    got_c = st.dot_i8_u32(torch.from_numpy(a), t32(b), c=c)
    np.testing.assert_array_equal(back(got_c), want_c)


def test_dot_i8pair_matches_jax():
    rng = np.random.default_rng(44)
    M, K, N = 6, 1001, 4
    lo = rng.integers(0, 128, (M, K)).astype(np.int8)
    hi = rng.integers(0, 4, (M, K)).astype(np.int8)
    b = u32(rng, (K, N))
    want = np.asarray(jax.jit(sj._dot_i8pair_u32)(lo, hi, b))
    got = st.dot_i8pair_u32(torch.from_numpy(lo), torch.from_numpy(hi), t32(b))
    np.testing.assert_array_equal(back(got), want)


@pytest.mark.parametrize("nq", [1, 3, 4, 8])
def test_select_is_the_diagonal_of_the_full_product(nq):
    """server_jax.py:456-458: Z = db @ q1 + 128 colsum(q1), then each row
    takes the column of its row batch."""
    rng = np.random.default_rng(45)
    M, K = 29, 50
    a = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = u32(rng, (K, nq))
    z = np.asarray(sj._dot_i8_u32(a, b)) \
        + (U32(128) * b.sum(axis=0, dtype=U32))[None, :]
    bidx = np.minimum(np.arange(M) // (M // nq), nq - 1)
    got = st.dot_i8_select(torch.from_numpy(a), t32(b), c=128)
    np.testing.assert_array_equal(back(got), z[np.arange(M), bidx])
    np.testing.assert_array_equal(st.batch_index(M, nq, "cpu").numpy(), bidx)


def test_unsquish_limbs_match_jax():
    rng = np.random.default_rng(46)
    h1_sq = u32(rng, (8, 5), 30)
    lo_j, hi_j = sj._unsquish_limbs(jnp.asarray(h1_sq))
    lo, hi = st._unsquish_limbs(t32(h1_sq))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))
    d = lo.to(torch.int64) + (hi.to(torch.int64) << 7)
    np.testing.assert_array_equal(back(st._squish_digits(d)), h1_sq)


def test_kernel_rows_are_copied_only_when_unaligned():
    a = torch.zeros((3, 10), dtype=torch.int8)          # stride 10
    b = st._kernel_rows(a)
    assert b.stride(0) % 4 == 0 and torch.equal(a, b) and b is not a
    c = st.aligned_rows(3, 10, "cpu", fill=-128)
    assert st._kernel_rows(c) is c and int(c.min()) == -128
    d = torch.zeros((3, 12), dtype=torch.int8)
    assert st._kernel_rows(d) is d
    assert st._kernel_rows(d[:, :10]) is not None


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros((4, 6), dtype=torch.int8)
    b = torch.zeros((6, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        st.dot_i8_u32(a.to(torch.int32), b)
    with pytest.raises(ValueError):
        st.dot_i8_u32(a, b[:5])
    with pytest.raises(ValueError):
        st.dot_i8_select(a, torch.zeros((6, 9), dtype=torch.int32))
    with pytest.raises(ValueError):
        dk.matmul_u32(b, b)
    with pytest.raises(ValueError):
        dk.mat_mul_vec_packed(torch.zeros((4, 2), dtype=torch.int32), b[:5])
    with pytest.raises(ValueError):
        dk.matmul_u32(torch.zeros((2, 6), dtype=torch.int32, device="meta"),
                      b.to("meta"))
    with pytest.raises(ValueError):
        dk.answer_products(torch.zeros((4, 2), dtype=torch.int32), b, b[:5])
    with pytest.raises(ValueError):
        dk._answer_launch(torch.zeros((4, 2), dtype=torch.int32), b, b)


def test_cpu_tensors_build_and_launch_nothing(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(_build.LAUNCHES)
    rng = np.random.default_rng(47)
    a = torch.from_numpy(rng.integers(-128, 128, (5, 9)).astype(np.int8))
    st.dot_i8_select(a, t32(u32(rng, (9, 2))))
    dk.matmul_u32(t32(u32(rng, (5, 9))), t32(u32(rng, (9, 2))))
    dk.mat_mul_vec_packed(t32(u32(rng, (5, 3), 30)), t32(u32(rng, (9, 2))))
    dk.answer_products(t32(u32(rng, (5, 3), 30)), t32(u32(rng, (9, 2))),
                       t32(u32(rng, (9, 1))))
    assert _build.LAUNCHES == before
    assert {"dp_dot_i8", "dp_matmul_u32"} <= set(before)


@pytest.fixture(scope="module")
def general_db():
    num_entries = 1 << 12
    params = pick_params(num_entries, 1, SEC_PARAM, LOGQ, lower_bound_m=1)
    rng = np.random.default_rng(48)
    idx = int(rng.integers(0, num_entries))
    vals = rng.integers(0, 2, num_entries, dtype=np.uint64)
    vals[idx] = 1
    return num_entries, params, idx, vals.tolist(), rng


def test_e2e_with_device_setup_matmul(general_db):
    """scheme.setup with the port's device matmul plugged in (the general
    branch of the checklist bucket) gives the host scheme's state."""
    num_entries, params, idx, vals, rng = general_db
    out = []
    for mm in (None, functools.partial(dk.matmul_u32_device, device="cpu")):
        db = Db.from_entries(num_entries, 1, params, vals)
        shared = scheme.init(db.info, params)
        out.append(scheme.setup(db, shared, params, matmul_u32_fn=mm))
    for g, w in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        np.testing.assert_array_equal(g, w)
    state, hint = out[1]
    cs, q = scheme.query(idx, shared, params, db.info, rng)
    ans = scheme.answer(db, [q], state, params)
    assert scheme.recover(idx, 0, hint, q, ans, shared, cs, params,
                          db.info) == 1


def test_answer_with_device_kernels_and_resident_state(general_db):
    """scheme.answer through device_kernels, with the squished DB and H1
    kept as tensors (as the bucket keeps them), equals the host answer and
    DoublePirAnswerJax's matvecs."""
    num_entries, params, idx, vals, rng = general_db
    db = Db.from_entries(num_entries, 1, params, vals)
    shared = scheme.init(db.info, params)
    state, hint = scheme.setup(db, shared, params)
    cs, q = scheme.query(idx, shared, params, db.info, rng)
    ans_host = scheme.answer(db, [q], state, params)
    eng_j = jk.DoublePirAnswerJax(db.data, state[0])
    eng_t = dk.DoublePirAnswerTorch(db.data, state[0], "cpu")
    np.testing.assert_array_equal(eng_t.db_rows_times(2, 9, q[0]),
                                  eng_j.db_rows_times(2, 9, q[0]))
    np.testing.assert_array_equal(eng_t.h1_times(q[1]), eng_j.h1_times(q[1]))
    db.data = dk.as_u32_tensor(db.data, "cpu")
    state[0] = dk.as_u32_tensor(state[0], "cpu")
    ans_dev = scheme.answer(db, [q], state, params,
                            kernels=dk.device_kernels("cpu"))
    for a, b in zip(ans_host, ans_dev):
        np.testing.assert_array_equal(a, b)
    assert scheme.recover(idx, 0, hint, q, ans_dev, shared, cs, params,
                          db.info) == 1
