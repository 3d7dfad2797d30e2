"""Kernels H (csrc/ingest.cu) and H' (csrc/compact_to_dense.cu) modelled in
numpy, step by step as the kernels run them.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py).
Here their schedules are rebuilt from their own index expressions:

* H: transform_kernel's reads of each chunk's logp-bit fields (4-byte word
  loads only where every chunk starts on a word); the host's sector plan
  (kv/ingest.py:sector_plan); transform_kernel's scratch rows in the plan's order, batch by batch; sector_kernel's
  (group, chunk, channel, z) blocks and (part, z) threads, each storing
  its kW bytes of a sector a limb, a partial group's stores keeping the
  bytes of its absent members. Every byte the items own is written once,
  no two groups share a sector, every other byte keeps its value (the
  index is prefilled with random bytes), and the index equals
  db_write_items(ingest_plain(...)) and, at one small set of params, the
  same writes of the JAX package's ingest_items_device.
* H': the tile of kv/ingest.py:migrate_tiling; rows_kernel's blocks
  (tile, y) walking rows y, y + by, ..., their slot list, the cp.async
  copies of a row's slot words, the scatter into the zeroed dense tile and
  its 16-byte stores decoded with shifts. Every dense byte is written once,
  an occupied slot at column 0 is placed, unoccupied slots with random
  idx_j and bytes are not, and the index equals compact_to_dense_plain.

Integer results: the tolerance is 0.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu.kv import ingest as ingest_jax
from sdk_tpu_torch.kv import ingest
from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)

torch.set_num_threads(1)

FAST = get_fast_expansion_testing_params()          # 4 bins a row
P16 = params_from_json(                             # p = 16, 4 bins a row
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 16, "q2_bits": 20, "t_gsw": 8,'
    ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
    ' "version": 0}')
NPR16 = params_from_json(                           # 16 bins: 32-byte sectors
    '{"n": 2, "nu_1": 3, "nu_2": 4, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 2,'
    ' "version": 1}')
NPR2 = params_from_json(                            # 2 bins: 8-byte sectors
    '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')
ODD = params_from_json(                             # 251-byte chunks
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,'
    ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
    ' "db_item_size": 1001, "version": 0}')
Z = 2048
Z_TILE = 128                  # csrc/ingest.cu kZTile
GROUP = 128                   # csrc/ntt_device.cuh kGroup: threads a block


def raw_items(params, rng, K):
    chunks = params.instances * params.n * params.n
    raw = rng.integers(0, 256, (K, chunks, params.bytes_per_chunk()),
                       dtype=np.uint8)
    if K > 2:
        raw[2] = 0
    return torch.from_numpy(raw)


def emulate_fields(params, raw):
    """transform_kernel's reads: the logp-bit fields (K, chunks, n_coeffs)
    of each chunk of ``raw`` (uint8, contiguous from a 4-byte-aligned base),
    thread j taking coefficients 4j + 512 rr + e. Where logp = 8 and the
    chunk size is a multiple of 4 (launch_transform), four coefficients are
    one 4-byte load, which must be aligned; otherwise a 4-byte window is
    read a byte at a time, zero past the chunk's end."""
    K, chunks, cb = raw.shape
    logp = int(np.log2(params.pt_modulus))
    n_coeffs = params.modp_words_per_chunk()
    flat = raw.numpy().reshape(-1)
    start = (np.arange(K * chunks) * cb).reshape(K, chunks, 1)
    j, rr, e = np.ix_(np.arange(GROUP), np.arange(4), np.arange(4))
    x = (4 * j + 512 * rr + e).reshape(-1)
    words = logp == 8 and cb % 4 == 0
    if words:
        b0 = (4 * j + 512 * rr).reshape(-1)     # (j, rr): four bytes each
        at = start + b0
        assert np.all(at % 4 == 0)          # an aligned 4-byte load
        four = np.zeros(at.shape, np.uint32)
        inside = b0 < cb
        w4 = flat[np.minimum(at[..., None] + np.arange(4), flat.size - 1)]
        four[..., inside] = (w4.astype(np.uint32) << (8 * np.arange(
            4, dtype=np.uint32)))[..., inside, :].sum(-1, dtype=np.uint32)
        w = (four[..., :, None] >> (8 * np.arange(4, dtype=np.uint32))) & 255
        w = w.reshape(K, chunks, -1)
    else:
        bit = logp * x
        win = np.zeros((K, chunks, x.size), np.uint32)
        for b in range(4):
            byte = (bit >> 3) + b
            got = flat[np.minimum(start + byte, flat.size - 1)]
            win |= np.where(byte < cb, got, 0).astype(np.uint32) << (8 * b)
        w = (win >> (bit & 7)) & ((1 << logp) - 1)
    out = np.zeros((K, chunks, Z), np.int64)
    out[..., x] = np.where(x < n_coeffs, w, 0)
    return out[..., :n_coeffs], words


@pytest.mark.parametrize("name", ["p256_2048", "p256_251", "p16"])
def test_transform_reads_each_field(name):
    """The kernel's field reads equal the plain version's fields: word loads
    at 2,048-byte chunks, byte reads at 251-byte chunks (whose word loads
    would be misaligned) and at p = 16."""
    params, want_words = {"p256_2048": (FAST, True), "p256_251": (ODD, False),
                          "p16": (P16, False)}[name]
    raw = raw_items(params, np.random.default_rng(9), 5)
    got, words = emulate_fields(params, raw)
    assert words == want_words
    logp = int(np.log2(params.pt_modulus))
    bits = np.unpackbits(raw.numpy(), axis=-1, bitorder="little")
    n = params.modp_words_per_chunk()
    bits = np.pad(bits, ((0, 0), (0, 0), (0, n * logp - bits.shape[-1])))
    want = (bits.reshape(raw.shape[:2] + (n, logp)).astype(np.int64)
            << np.arange(logp)).sum(-1)
    assert np.array_equal(got, want)


def test_odd_chunk_bytes_match_jax_ingest():
    """At 251-byte chunks the plan's writes of the JAX package's
    ingest_items_device residues equal the port's plain route (tolerance
    0)."""
    params = ODD
    rng = np.random.default_rng(10)
    raw = raw_items(params, rng, 7)
    bins, cols = pairs(params, [0, 1, 2, 5, 9, 14, 15])
    pj = params_j.params_from_json(json.dumps(params_to_json_obj(params)))
    residues = np.asarray(jax.jit(lambda rb: ingest_jax.ingest_items_device(
        pj, rb))(jnp.asarray(raw.numpy())))
    assert torch.equal(torch.from_numpy(residues.astype(np.int32)),
                       ingest.ingest_plain(params, raw))
    check_ingest(params, sj.db_shape(params), bins, cols, raw, 128, 11)


def emulate_ingest(params, target, bins, cols, residues, batch_items):
    """Kernel H's launch over ``target`` (int8, changed in place) with the
    transform's output ``residues`` (K, chunks, 2, z); returns the count of
    stores of each byte and the plan."""
    K, chunks = residues.shape[:2]
    npr = 1 << params.db_dim_2
    jw = target.shape[3]
    plan = ingest.sector_plan(npr, chunks, bins, cols, batch_items)
    row_bytes, it_bytes = jw * chunks * npr * 4, npr * 4
    flat = target.view(-1).numpy()
    writes = np.zeros(flat.size, np.int32)
    M = plan.members
    kW = min(16, M)
    m = np.arange(M)
    part, byte = m // kW, m % kW            # the thread (part, z) of byte m
    IT, C, ZT, ZL, L = np.ix_(np.arange(chunks), np.arange(2),
                              np.arange(Z // Z_TILE), np.arange(Z_TILE),
                              np.arange(4))
    res = residues.numpy().astype(np.int64)
    stores = 0
    scratch_rows = int(np.diff(plan.batches[:, 1]).max(initial=0))
    assert plan.batches[0, 0] == 0 and tuple(plan.batches[-1]) == (
        len(plan.table), K)
    for (g0, p0), (g1, p1) in zip(plan.batches[:-1], plan.batches[1:]):
        assert g1 > g0 and 0 < p1 - p0 <= scratch_rows
        assert p1 - p0 <= max(batch_items, M)
        scratch = res[plan.order[p0:p1]]   # transform_kernel: row r = p0 + r
        for g in range(g0, g1):
            pos = plan.table[g]
            present = pos >= 0
            assert plan.groups[g, 1] == present.all()
            assert np.all((pos[present] >= p0) & (pos[present] < p1))
            # the block's stage: member m's row of this (it, c, z tile)
            rows = scratch[np.where(present, pos - p0, 0)]     # (M, it, c, z)
            v = rows.reshape(M, chunks, 2, Z // Z_TILE, Z_TILE, 1)
            v = np.moveaxis(v, 0, -1)                         # (..., 1, M)
            limbs = (v >> (7 * L[..., None])) & 127
            zi = ZT * Z_TILE + ZL
            off = (plan.groups[g, 0] + IT * it_bytes
                   + ((C * Z + zi) * 4 + L) * row_bytes)[..., None] \
                + part * kW + byte
            flat[off] = np.where(present, limbs, flat[off]).astype(np.int8)
            writes[off.ravel()] += 1
            stores += off.size
    assert writes.sum() == stores          # no byte stored twice by a group
    return writes, plan


def plain_ingest(params, target, bins, cols, raw):
    sj.db_write_items(params, target, bins, cols,
                      ingest.ingest_plain(params, raw))


def check_ingest(params, shape, bins, cols, raw, batch_items, seed):
    """The emulated kernel against the plain route over a prefilled index:
    stores once, owned bytes new, the rest unchanged."""
    rng = np.random.default_rng(seed)
    start = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))
    want = start.clone()
    plain_ingest(params, want, bins, cols, raw)
    got = start.clone()
    writes, plan = emulate_ingest(params, got, bins, cols,
                                  ingest.ingest_plain(params, raw),
                                  batch_items)
    assert writes.max() <= 1
    assert len(np.unique(plan.groups[:, 0])) == len(plan.groups)
    assert torch.equal(got, want)
    # the items' own bytes are stored; a byte no sector holds keeps its value
    owned = torch.zeros(shape, dtype=torch.bool)
    view = owned.view(shape[:4] + (-1, shape[6], 4))
    view[:, :, :, np.asarray(cols) // 4, :, np.asarray(bins),
         np.asarray(cols) % 4] = True
    owned = owned.view(-1).numpy()
    assert writes[owned].min(initial=1) == 1
    assert torch.equal(got.view(-1)[torch.from_numpy(writes == 0)],
                       start.view(-1)[torch.from_numpy(writes == 0)])
    return plan


def pairs(params, idxs):
    npr = 1 << params.db_dim_2
    idxs = np.asarray(idxs)
    return idxs % npr, idxs // npr


CASES = {
    # name: (params, target, item indices or None (random), K, batch_items)
    "dense_neighbouring": (FAST, "dense", range(64, 128), 0, 128),
    "dense_scattered": (FAST, "dense", None, 20, 128),
    "dense_batches": (FAST, "dense", range(0, 96), 0, 32),
    "dense_bin0_col0": (FAST, "dense", [0, 5, 200, 255], 0, 128),
    "compact_cap8": (FAST, "compact", None, 24, 128),
    "p16": (P16, "dense", None, 7, 128),
    "npr16_full_and_partial": (NPR16, "dense", list(range(64)) + [70, 99, 127],
                               0, 40),
    "npr2": (NPR2, "dense", None, 9, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sector_plan_writes_each_sector_once(case):
    params, target, idxs, K, batch_items = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    npr = 1 << params.db_dim_2
    shape = (sj.db_shape(params) if target == "dense"
             else sj.compact_shape(params, 8))
    if idxs is None:
        flat = rng.choice(npr * 4 * shape[3], K, replace=False)
        bins, cols = flat % npr, flat // npr
    else:
        bins, cols = pairs(params, idxs)
    raw = raw_items(params, rng, len(bins))
    plan = check_ingest(params, shape, bins, cols, raw, batch_items, 7)
    if case in ("dense_neighbouring", "dense_batches"):
        assert plan.groups[:, 1].all()      # a bulk load: whole sectors
    if case == "dense_batches":
        assert len(plan.batches) - 1 == 3
    if case == "dense_scattered":
        assert not plan.groups[:, 1].any()


def test_sector_plan_group_split_across_flush_chunks():
    """One group's items in two launches (a flush chunk ends inside it):
    both launches treat it as partial and keep each other's bytes."""
    params = FAST
    rng = np.random.default_rng(3)
    shape = sj.db_shape(params)
    bins, cols = pairs(params, range(16, 48))
    raw = raw_items(params, rng, 32)
    start = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8))
    want = start.clone()
    plain_ingest(params, want, bins, cols, raw)
    got = start.clone()
    for s, e in ((0, 21), (21, 32)):
        _, plan = emulate_ingest(params, got, bins[s:e], cols[s:e],
                                 ingest.ingest_plain(params, raw[s:e]), 128)
        assert not plan.groups[:, 1].all()
    assert torch.equal(got, want)


def test_sector_plan_sharded_local_columns():
    """The sharded flush's items on one shard of a (dp=2, db=2) mesh: local
    columns into the shard's (trials / 2, dim0 / 2) block, the chunk bytes
    of its trials (kv/ingest.py:_flush_sharded)."""
    params = FAST
    rng = np.random.default_rng(4)
    inst, trials = params.instances, params.n * params.n
    full = sj.db_shape(params)
    jw_l, t_l = full[3] // 2, trials // 2
    shape = full[:3] + (jw_l, inst, t_l) + full[6:]
    idxs = rng.choice(params.num_items(), 30, replace=False)
    bins, cols = pairs(params, np.sort(idxs))
    raw = raw_items(params, rng, 30).reshape(30, inst, trials, -1)
    g, j = 1, 1                                 # the shard's block
    sel = cols // (4 * jw_l) == j
    part = raw[torch.from_numpy(sel)][:, :, g * t_l:(g + 1) * t_l].reshape(
        int(sel.sum()), inst * t_l, -1).contiguous()
    check_ingest(params, shape, bins[sel], cols[sel] - j * 4 * jw_l, part,
                 128, 8)


def test_sector_plan_rejects_repeated_pairs():
    with pytest.raises(ValueError):
        ingest.sector_plan(4, 4, [1, 2, 1], [3, 3, 3])


def test_sector_plan_matches_jax_ingest():
    """The plan's writes of the JAX package's ingest_items_device residues
    equal the port's plain route (tolerance 0)."""
    params = FAST
    rng = np.random.default_rng(5)
    raw = raw_items(params, rng, 12)
    bins, cols = pairs(params, [0, 1, 2, 3, 4, 6, 7, 33, 90, 130, 131, 255])
    pj = params_j.params_from_json(json.dumps(params_to_json_obj(params)))
    residues = np.asarray(jax.jit(lambda rb: ingest_jax.ingest_items_device(
        pj, rb))(jnp.asarray(raw.numpy())))
    start = torch.from_numpy(rng.integers(-128, 128, sj.db_shape(params),
                                          dtype=np.int8))
    want = start.clone()
    plain_ingest(params, want, bins, cols, raw)
    got = start.clone()
    emulate_ingest(params, got, bins, cols,
                   torch.from_numpy(residues.astype(np.int32)), 128)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- kernel H'

def emulate_migrate(planes, idx_j, counts, jw, tl, sms=132, per_sm=3):
    """Kernel H''s launch: the new dense index (flat) and the stores of each
    of its bytes."""
    rows = int(np.prod(planes.shape[:3]))
    cw, inst, trials, npr = planes.shape[3:7]
    it_n, cap = inst * trials, 4 * cw
    src = planes.reshape(-1).numpy()
    idx = idx_j.numpy().reshape(-1)
    log_npr, log_it, log_jw = (int(x).bit_length() - 1
                               for x in (npr, tl.it_t, tl.jw_t))
    log_run = log_it + log_npr + 2
    log_upj = log_run - 4
    assert log_upj >= 0
    row_it = it_n * npr * 4
    in_row, out_row = cw * row_it, jw * row_it
    it_tiles = it_n // tl.it_t
    tiles = it_tiles * (jw // tl.jw_t)
    by = min(rows, -(-sms * per_sm // tiles))
    dense = np.full(rows * out_row, 99, np.int8)
    writes = np.zeros(rows * out_row, np.int32)
    upj_mask = (1 << log_upj) - 1
    tile_bytes = 1 << (log_jw + log_run)
    u = np.arange(tile_bytes // 16)
    ch = np.arange(tl.cw_used << log_upj)
    for tile in range(tiles):
        it0 = (tile % it_tiles) << log_it
        jw0 = (tile // it_tiles) << log_jw
        # the slot list
        i = np.arange(npr * cap)
        b, s = i & (npr - 1), i >> log_npr             # bin fastest
        j = idx[b * cap + s]
        jl = (j >> 2) - jw0
        keep = ((s < np.minimum(counts[b], cap)) & (j >= 0) & (j < 4 * jw)
                & (jl >= 0) & (jl < tl.jw_t))
        assert keep.sum() <= tl.list_max
        lsrc = ((s >> 2) << log_run) + (b << 2) + (s & 3)
        ldst = (jl << log_run) + (b << 2) + (j & 3)
        lsrc, ldst = lsrc[keep], ldst[keep]
        assert lsrc.max(initial=0) < 1 << 16 and ldst.max(initial=0) < 1 << 16
        for y in range(by):
            rr = np.arange(y, rows, by)[:, None]
            # the cp.async copies of each row's slot words
            base = rr * in_row + it0 * npr * 4 + (ch >> log_upj) * row_it \
                + 16 * (ch & upj_mask)
            stage = src[(base[..., None] + np.arange(16)).reshape(
                len(rr), -1)]
            tb = np.zeros((len(rr), tile_bytes), np.int8)
            for il in range(tl.it_t):
                tb[:, ldst + il * npr * 4] = stage[:, lsrc + il * npr * 4]
            out = rr * out_row + it0 * npr * 4 + (jw0 + (u >> log_upj)) \
                * row_it + 16 * (u & upj_mask)               # (rows, units)
            at = (out[..., None] + np.arange(16)).reshape(len(rr), -1)
            dense[at] = tb
            writes[at] += 1
    return dense, writes


def compact_index(params, cap, rng, items, scribble=True):
    """A compact index of ``items`` through the plain flush; unoccupied
    slots then hold random bytes and random idx_j."""
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    buf = ingest.DbUpdateBuffer(params, "cpu")
    for i in items:
        buf.upsert_raw(i, rng.integers(0, 256, row_len, dtype=np.uint8)
                       .tobytes())
    db = buf.flush(sj.compact_db_empty(params, "cpu", cap_bin=cap))
    counts = buf.slots.bin_count.copy()
    planes, idx_j = db.planes.clone(), db.idx_j.clone()
    if scribble:
        for b in range(idx_j.shape[0]):
            for s in range(int(counts[b]), db.cap_bin):
                planes[:, :, :, s // 4, :, :, b, s % 4] = torch.from_numpy(
                    rng.integers(1, 128, planes.shape[:3] + planes.shape[4:6],
                                 dtype=np.int8))
                idx_j[b, s] = int(rng.integers(0, 1 << params.db_dim_1))
    return sj.CompactDb(planes, idx_j), counts


MIGRATE_CASES = {
    "cap8_column0": (FAST, 8, [0, 4, 9, 17, 255]),
    "cap16": (FAST, 16, [4 * i + (i % 3) for i in range(40)]),
    "empty": (FAST, 8, []),
    "npr16": (NPR16, 8, list(range(0, 128, 3))),
    "npr2": (NPR2, 8, [0, 1, 3, 6, 9, 12]),
}


@pytest.mark.parametrize("case", list(MIGRATE_CASES))
def test_migrate_schedule_writes_each_byte_once(case):
    params, cap, items = MIGRATE_CASES[case]
    rng = np.random.default_rng(50 + sorted(MIGRATE_CASES).index(case))
    db, counts = compact_index(params, cap, rng, items)
    want = ingest.compact_to_dense_plain(params, db, counts)
    if 0 in items:
        assert want[:, :, :, 0, :, :, 0, 0].any()
    planes = db.planes
    cw, inst, trials, npr = planes.shape[3:7]
    jw = sj.db_shape(params)[3]
    tl = ingest.migrate_tiling(cw, jw, inst * trials, npr,
                               int(counts.max(initial=0)))
    assert tl.cw_used * 4 >= min(int(counts.max(initial=0)), 4 * cw)
    assert tl.it_t * npr >= 4
    dense, writes = emulate_migrate(planes, db.idx_j, counts, jw, tl)
    assert writes.min() == 1 and writes.max() == 1
    assert torch.equal(torch.from_numpy(dense).view(want.shape), want)


def test_migrate_tiling_at_the_1gib_bucket():
    """The tiles of the full-size indexes: the S2 state (cap 128, the
    fullest bin ~70) and the fill's cap 64 take whole rows of column words
    two chunks at a time, two blocks an SM; a full cap 512 cuts the columns
    so that its slot list fits. Every tile fits shared memory and the
    list's 16-bit offsets."""
    jw, it_n, npr = 128, 16, 64
    for cw, count, want in ((32, 70, (2, 128)), (16, 64, (2, 128)),
                            (128, 512, (1, 32))):
        tl = ingest.migrate_tiling(cw, jw, it_n, npr, count)
        assert (tl.it_t, tl.jw_t) == want
        tile = tl.jw_t * tl.it_t * npr * 4
        stage = tl.cw_used * tl.it_t * npr * 4
        smem = tile + 4 * tl.list_max + 2 * stage
        assert tile <= 1 << 16 and stage <= 1 << 16
        assert smem <= (226 * 1024 // 2 if count <= 128 else 226 * 1024)
    assert ingest.migrate_tiling(32, jw, it_n, npr, 0).cw_used == 0
