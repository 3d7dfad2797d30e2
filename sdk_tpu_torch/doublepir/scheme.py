"""The DoublePIR protocol: init / setup / query / answer / recover.

Host (numpy uint32, wrapping) implementation with semantics matching
lib/doublepir/src/doublepir/doublepir.rs. The heavy server matmuls can be
swapped for the device kernels in .kernels (setup hint build and online
answer; both are plain wrapping-u32 matmuls).

States are lists of uint32 matrices, as in the reference's `State`
serializer type.
"""

from __future__ import annotations

import numpy as np

from .database import Db, DbInfo
from .debug import print_checksum
from .matrix import (SEEDS_SHORT, SQUISH_DELTA, U32, U64, derive_from_seed,
                     expand, gaussian, mat_mul_transposed_packed,
                     mat_mul_vec_packed, matmul_u32, random_logmod, squish,
                     transpose_expand_concat_cols_squish)
from .params import Params

State = list  # list of np.uint32 arrays


def concat_cols(m: np.ndarray, n: int) -> np.ndarray:
    """Interleaved column fold (reference indexing.rs concat_cols):
    out[i + rows*(j%n)][j//n] = m[i][j]."""
    if n == 1:
        return m
    rows, cols = m.shape
    assert cols % n == 0
    out = np.zeros((rows * n, cols // n), dtype=U32)
    j = np.arange(cols)
    for blk in range(n):
        sel = j[j % n == blk]
        out[rows * blk : rows * (blk + 1), :] = m[:, sel]
    return out


def init(info: DbInfo, params: Params) -> State:
    """Shared pseudorandom matrices A1 (m, n) and A2 (l/x, n) derived from the
    fixed public AES seeds (doublepir.rs:46-51)."""
    a_1 = derive_from_seed(params.m, params.n, SEEDS_SHORT[0])
    a_2 = derive_from_seed(params.l // info.x, params.n, SEEDS_SHORT[1])
    return [a_1, a_2]


def setup(db: Db, shared: State, params: Params,
          matmul_u32_fn=None) -> tuple[State, State]:
    """Builds (server_state, client_hint); squishes db in place
    (doublepir.rs:76-108). `matmul_u32(a, b)` may be a device kernel."""
    mm = matmul_u32_fn or matmul_u32
    a_1, a_2 = shared
    h_1 = mm(db.data, a_1)                       # (l, n), wrapping
    h_1 = np.ascontiguousarray(h_1.T)            # (n, l)
    h_1 = expand(h_1, params.p, params.delta())  # (n*delta, l)
    h_1 = concat_cols(h_1, db.info.x)            # (n*delta*x, l/x)
    h_2 = mm(h_1, a_2)                           # (n*delta*x, n)

    db.data = db.data + U32(params.p // 2)
    db.squish()

    h_1 = h_1 + U32(params.p // 2)
    h_1 = squish(h_1)

    a_2_copy = a_2
    if a_2_copy.shape[0] % SQUISH_DELTA != 0:
        pad = SQUISH_DELTA - (a_2_copy.shape[0] % SQUISH_DELTA)
        a_2_copy = np.vstack([a_2_copy, np.zeros((pad, a_2_copy.shape[1]),
                                                 dtype=U32)])
    a_2_t = np.ascontiguousarray(a_2_copy.T)

    # divergence-hunting fingerprints (reference doublepir.rs:102-105)
    print_checksum("H1", h_1)
    print_checksum("A2_copy", a_2_copy)
    print_checksum("H2", h_2)
    print_checksum("DB.data", db.data)

    return [h_1, a_2_t], [h_2]


def query_indices(i: int, params: Params, info: DbInfo) -> tuple[int, int]:
    idx = i // info.packing if info.packing > 0 else i
    i1 = (idx // params.m) * (info.ne // info.x)
    i2 = idx % params.m
    return i1, i2


def query(i: int, shared: State, params: Params, info: DbInfo,
          rng: np.random.Generator) -> tuple[State, State]:
    """LWE encryptions of unit vectors for both levels (doublepir.rs:111-163).
    Returns (client_state, query_msg)."""
    a_1, a_2 = shared
    i1, i2 = query_indices(i, params, info)

    secret1 = random_logmod(params.n, 1, params.logq, rng)
    err1 = gaussian(params.m, 1, rng)
    query1 = matmul_u32(a_1, secret1) + err1
    query1[i2, 0] += U32(params.ext_delta() & 0xFFFFFFFF)
    sq = SQUISH_DELTA
    if params.m % sq != 0:
        query1 = np.vstack([query1, np.zeros((sq - params.m % sq, 1), dtype=U32)])
    print_checksum("query1", query1)  # reference doublepir.rs:136

    state: State = [secret1]
    msg: State = [query1]
    lx = params.l // info.x
    for j in range(info.ne // info.x):
        secret2 = gaussian(params.n, 1, rng)    # error-distribution secret
        err2 = gaussian(lx, 1, rng)
        query2 = matmul_u32(a_2, secret2) + err2
        # wrapping u32 add (mod 2^32 is the scheme's arithmetic); go via
        # Python int so numpy doesn't warn on the intended overflow
        query2[i1 + j, 0] = U32(
            (int(query2[i1 + j, 0]) + params.ext_delta()) & 0xFFFFFFFF)
        if lx % sq != 0:
            query2 = np.vstack([query2, np.zeros((sq - lx % sq, 1), dtype=U32)])
        print_checksum("query2", query2)  # reference doublepir.rs:157
        state.append(secret2)
        msg.append(query2)
    return state, msg


def answer(db: Db, queries: list[State], server: State, params: Params,
           raw_data: np.ndarray | None = None,
           chunk_idx: int | None = None,
           kernels=None) -> State:
    """Batch answer: each query selects a column from its row-batch of the DB
    (doublepir.rs:246-350). db must be squished. `kernels` may supply
    (mat_mul_vec_packed, mat_mul_transposed_packed) device implementations."""
    mv, mt = kernels if kernels else (mat_mul_vec_packed,
                                      mat_mul_transposed_packed)
    h_1, a_2_t = server[0], server[1]
    data = raw_data if raw_data is not None else db.data
    # batch partitioning always follows the FULL DB height, even when this
    # node only holds a row-chunk (raw_data + chunk_idx — the sharding mode)
    num_rows = db.data.shape[0] if db.data.size else data.shape[0]
    num_queries = len(queries)
    batch_sz = num_rows // num_queries

    parts = []
    last = 0
    for batch, q in enumerate(queries):
        if batch == num_queries - 1:
            batch_sz = num_rows - last
        start_row = last
        if chunk_idx is not None:
            start_row = 0
            if batch != chunk_idx:
                parts.append(np.zeros((batch_sz, 1), dtype=U32))
                last += batch_sz
                continue
        parts.append(mv(data[start_row : start_row + batch_sz],
                                        q[0]))
        last += batch_sz
    a_1 = np.vstack(parts)                       # (l, 1)
    print_checksum("a1", a_1)                    # reference doublepir.rs:317

    a_1t = transpose_expand_concat_cols_squish(
        a_1, params.p, params.delta(), db.info.x)
    print_checksum("a1 (#2)", a_1t)              # reference doublepir.rs:322
    msg: State = [mt(a_1t, a_2_t)]  # (delta*x, n)
    print_checksum("h1", msg[0])                 # reference doublepir.rs:330

    # batch all second-level queries into single matvec passes over H1/a_1t
    q2_cols = [q[1 + j] for q in queries
               for j in range(db.info.ne // db.info.x)]
    q2_all = np.concatenate(q2_cols, axis=1)      # (l3, K)
    a_2_all = mv(h_1, q2_all)                     # (n*delta*x, K)
    h_2_all = mv(a_1t, q2_all)                    # (delta*x, K)
    for k in range(q2_all.shape[1]):
        msg.append(np.ascontiguousarray(a_2_all[:, k : k + 1]))
        msg.append(np.ascontiguousarray(h_2_all[:, k : k + 1]))
        print_checksum("a_2", msg[-2])           # reference doublepir.rs:340
        print_checksum("h_2", msg[-1])           # reference doublepir.rs:341
    return msg


def recover(i: int, batch_index: int, offline: State, query_msg: State,
            answer_msg: State, shared: State, client: State, params: Params,
            info: DbInfo) -> int:
    """Decrypt + round + recompose one entry (doublepir.rs:352-459)."""
    h_2 = offline[0]
    h1 = answer_msg[0].copy()                    # (delta*x, n)
    secret1 = client[0]
    ratio = params.p // 2
    q = 1 << params.logq

    val1 = int(ratio) * int(query_msg[0][: params.m].astype(U64).sum()) % q
    val1 = (q - val1) % q
    lx = params.l // info.x
    val2 = int(ratio) * int(query_msg[1][:lx].astype(U64).sum()) % q
    val2 = (q - val2) % q

    if len(shared) > 0:
        a_2 = shared[1]                          # (l/x, n)
        col_sums = (U32(ratio) * a_2).astype(U64).sum(axis=0) % U64(q)
        val3 = ((q - col_sums.astype(np.int64)) % q).astype(U32)
        h1 = h1 + val3[None, :]

    delta = params.delta()
    offset = (info.ne // info.x * 2) * batch_index
    vals = []
    for k in range(info.ne // info.x):
        a2 = answer_msg[1 + 2 * k + offset]      # (n*delta*x, 1)
        h2m = answer_msg[2 + 2 * k + offset] + U32(val2 & 0xFFFFFFFF)
        secret2 = client[1 + k]
        for j in range(info.x):
            state = a2[j * params.n * delta : (j + 1) * params.n * delta] \
                + U32(val2 & 0xFFFFFFFF)
            state = np.vstack([state, h2m[j * delta : (j + 1) * delta]])
            hint = np.vstack([
                h_2[j * params.n * delta : (j + 1) * params.n * delta],
                h1[j * delta : (j + 1) * delta]])
            interm = matmul_u32(hint, secret2)   # wrapping
            state = state - interm
            state = params.round_vec(state)
            from .matrix import contract
            state = contract(state, params.p, delta)   # (n+1, 1)
            noised = (int(state[params.n, 0]) + val1) % q
            prods = (secret1[:, 0] * state[: params.n, 0])   # u32 wrap
            noised = (noised - int(prods.astype(U64).sum())) % q
            vals.append(params.round(noised))
    return Db.reconstruct_elem(vals, i, info)
