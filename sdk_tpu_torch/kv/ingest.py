"""DB ingestion on the device: row bytes -> NTT residues -> the index.

Ports sdk_tpu/kv/ingest.py (reference lib/server/src/db/loading.rs:278-377).
Each item splits into instances*n*n chunks; chunk bytes become mod-p
coefficients, are recentered into mod-Q, NTT'd and written, as 7-bit limbs,
at the item's (dim0, num_per) coordinates of the dense DB tensor, or at its
(bin, slot) of the compact one (spiral.CompactDb; slot bookkeeping in
CompactSlots). On a CUDA tensor all of that is one launch of kernel H
(csrc/ingest.cu) per flush chunk; on a CPU tensor ingest_plain and
spiral.db_write_items. compact_to_dense migrates a compact index to the
dense layout (kernel H', csrc/compact_to_dense.cu).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..arith import log2_exact
from ..params import Params

from .. import _build
from ..ops.ntt import ntt_forward_plain
from ..ops.ntt import tables as ntt_tables
from ..ops.shard import ShardedDb
from ..ops.spiral import (NUM_LIMBS, CompactDb, compact_shape, db_shape,
                          db_write_items)

# items ingested per flush step: one launch of kernel H each (the plain
# version's temporaries are ~0.6 MB per item at the 1 GiB bucket)
FLUSH_CHUNK_ITEMS = 1024


def _check_raw_bytes(params: Params, raw_bytes: torch.Tensor) -> None:
    if (raw_bytes.dtype != torch.uint8 or raw_bytes.ndim != 3
            or raw_bytes.shape[2] != params.bytes_per_chunk()):
        raise ValueError(f"ingest: expected uint8 (K, chunks, "
                         f"{params.bytes_per_chunk()}), got {raw_bytes.dtype} "
                         f"{tuple(raw_bytes.shape)}")


def ingest_plain(params: Params, raw_bytes: torch.Tensor) -> torch.Tensor:
    """ingest_items_device in plain PyTorch (the plain forward NTT, never a
    kernel). Any power-of-two p: logp-bit fields are read from each chunk's
    little-endian bitstream."""
    _check_raw_bytes(params, raw_bytes)
    logp = log2_exact(params.pt_modulus)
    n_coeffs = params.modp_words_per_chunk()
    if logp == 8:
        words = raw_bytes.to(torch.int64)
    else:
        offs = logp * np.arange(n_coeffs, dtype=np.int64)
        byte_start = torch.from_numpy(offs // 8).to(raw_bytes.device)
        shift = torch.from_numpy(offs % 8).to(raw_bytes.device)
        padded = torch.nn.functional.pad(raw_bytes, (0, 4)).to(torch.int64)
        win = torch.zeros(raw_bytes.shape[:2] + (n_coeffs,),
                          dtype=torch.int64, device=raw_bytes.device)
        for b in range(4):
            win |= padded.index_select(-1, byte_start + b) << (8 * b)
        words = (win >> shift) & ((1 << logp) - 1)
    centered = torch.where(words > params.pt_modulus // 2,
                           words - params.pt_modulus, words)
    q = torch.tensor(params.moduli, dtype=torch.int64,
                     device=raw_bytes.device).reshape(-1, 1)
    chans = centered.unsqueeze(-2) % q               # (K, chunks, crt, nc)
    pad = params.poly_len - chans.shape[-1]
    chans = torch.nn.functional.pad(chans, (0, pad)).to(torch.int32)
    return ntt_forward_plain(params, chans)


# items a transform / sector-writer pair of kernel H takes: its scratch of
# residues, INGEST_BATCH_ITEMS x chunks x 2 x z x 4 bytes, is 67.1 MB at the
# 1 GiB bucket
INGEST_BATCH_ITEMS = 256


class SectorPlan(NamedTuple):
    """Kernel H's work for one flush chunk: its items grouped by the 32-byte
    sector of the index they share (csrc/ingest.cu)."""
    order: np.ndarray     # (K,) int64: the item at each position; a group's
    #                       members are neighbouring positions
    table: np.ndarray     # (G, members) int32: the position of the item at
    #                       each byte of the group's sector, -1 for none
    groups: np.ndarray    # (G, 2) int64: the sector's byte offset in a (c, z,
    #                       l) row of the index at chunk 0; 1 if it is full
    batches: np.ndarray   # (B + 1, 2) int64: each batch's first group and
    #                       first position, then (G, K)
    members: int          # bytes of a sector: 4 columns x min(8, num_per) bins


def sector_plan(num_per: int, chunks: int, bins, cols,
                batch_items: int = INGEST_BATCH_ITEMS) -> SectorPlan:
    """Group K items at (bins[k], cols[k]) of an index [c, z, l, col/4,
    chunks, num_per, 4] by sector, (col // 4, bin // 8): a sector holds
    byte (bin % 8) * 4 + col % 4 of 8 neighbouring bins x 4 neighbouring
    columns (num_per bins where num_per < 8). Batches of whole groups hold
    at most batch_items items, or one group."""
    bins = np.asarray(bins, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    K = len(bins)
    bs = min(8, num_per)
    members = 4 * bs
    key = (cols // 4) * (num_per // bs) + bins // bs
    byte = (bins % bs) * 4 + cols % 4
    order = np.lexsort((byte, key))
    key, byte = key[order], byte[order]
    if np.any((key[1:] == key[:-1]) & (byte[1:] == byte[:-1])):
        raise ValueError("ingest: the (bin, column) pairs must be distinct")
    new = np.concatenate([[True], key[1:] != key[:-1]])[:K]
    first = np.flatnonzero(new)
    G = len(first)
    table = np.full((G, members), -1, dtype=np.int32)
    table[np.cumsum(new) - 1, byte] = np.arange(K, dtype=np.int32)
    gkey = key[first]
    base = ((gkey // (num_per // bs)) * chunks * num_per
            + (gkey % (num_per // bs)) * bs) * 4
    groups = np.stack([base, (table >= 0).all(1).astype(np.int64)], axis=1)
    starts, taken = [], batch_items
    for g, n in enumerate(np.diff(np.append(first, K)).tolist()):
        if taken + n > batch_items:
            starts.append(g)
            taken = 0
        taken += n
    batches = np.array([(g, first[g]) for g in starts] + [(G, K)],
                       dtype=np.int64)
    return SectorPlan(order, table, groups, batches, members)


def _ingest_launch(params: Params, raw_bytes: torch.Tensor, target=None,
                   bins=None, cols=None):
    """Kernel H (csrc/ingest.cu): with ``target`` (the dense DB tensor or the
    compact planes) the limbs of item k are written in place at num_per bin
    bins[k], column cols[k], sector by sector (sector_plan), and nothing is
    returned; without it the NTT residues (K, chunks, crt, z) int32 are."""
    _check_raw_bytes(params, raw_bytes)
    raw_bytes = raw_bytes.contiguous()
    if raw_bytes.data_ptr() % 4:            # the kernel reads 4-byte words
        raw_bytes = raw_bytes.clone()
    K, chunks, chunk_bytes = raw_bytes.shape
    dev = raw_bytes.device
    tb = ntt_tables(params, dev)
    num_per = 1 << params.db_dim_2
    if target is None:
        res = torch.empty((K, chunks, params.crt_count, params.poly_len),
                          dtype=torch.int32, device=dev)
        _build.require_cuda(raw_bytes, tb, res)
        ptrs, batches = (None, None, None), np.zeros((1, 2), np.int64)
        members, jw = 4, 0
    else:
        # a shard of a mesh holds some of the trials (ops/shard.py): the
        # items' chunk bytes are those of its trials
        jw, trials = (target.shape[3], target.shape[5]) if target.ndim == 8 \
            else (0, 0)
        if (target.dtype != torch.int8 or target.ndim != 8
                or tuple(target.shape) != (
                    params.crt_count, params.poly_len, NUM_LIMBS, jw,
                    params.instances, trials, num_per, 4)
                or chunks != params.instances * trials
                or params.crt_count != 2 or target.data_ptr() % 16):
            raise ValueError(f"ingest: bad index tensor {target.dtype} "
                             f"{tuple(target.shape)}")
        # checked on the host: the pairs come from the host's bookkeeping
        bins = np.asarray(bins, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if bins.shape != (K,) or cols.shape != (K,):
            raise ValueError("ingest: one (bin, column) pair per item")
        if K and (bins.min() < 0 or bins.max() >= num_per or cols.min() < 0
                  or cols.max() >= 4 * jw):
            raise ValueError("ingest: (bin, column) outside the index")
        plan = sector_plan(num_per, chunks, bins, cols)
        rows = int(np.diff(plan.batches[:, 1]).max(initial=0))
        res = torch.empty((rows, chunks, params.crt_count, params.poly_len),
                          dtype=torch.int32, device=dev)
        # the plan's three arrays in one upload
        parts = [np.ascontiguousarray(a).view(np.uint8).ravel()
                 for a in (plan.order, plan.table, plan.groups)]
        offs = np.cumsum([0] + [-(-len(a) // 16) * 16 for a in parts])
        host = np.zeros(offs[-1], dtype=np.uint8)
        for a, o in zip(parts, offs):
            host[o:o + len(a)] = a
        buf = torch.from_numpy(host).to(dev)
        _build.require_cuda(raw_bytes, tb, target, res, buf)
        ptrs = tuple(buf.data_ptr() + int(o) for o in offs[:3])
        batches, members = np.ascontiguousarray(plan.batches), plan.members
    q0, q1 = params.moduli
    _build.launch("ingest", "sdk_ingest", dev, raw_bytes.data_ptr(), *ptrs,
                  batches.ctypes.data, len(batches) - 1, tb.data_ptr(),
                  None if target is None else target.data_ptr(),
                  res.data_ptr(), K, chunks, chunk_bytes,
                  params.modp_words_per_chunk(),
                  log2_exact(params.pt_modulus), members,
                  jw * chunks * num_per * 4, num_per * 4,
                  params.poly_len_log2, q0, q1, _build.stream_of(raw_bytes))
    return res if target is None else None


def ingest_items_device(params: Params, raw_bytes: torch.Tensor) -> torch.Tensor:
    """(K, instances*trials, bytes_per_chunk) uint8 zero-padded chunk bytes
    -> (K, instances*trials, crt, poly_len) int32 NTT residues, computed on
    raw_bytes' device: kernel H on a CUDA tensor, ingest_plain on a CPU
    tensor."""
    if raw_bytes.device.type == "cuda":
        return _ingest_launch(params, raw_bytes)
    if raw_bytes.device.type == "cpu":
        return ingest_plain(params, raw_bytes)
    raise ValueError(f"unsupported device {raw_bytes.device}")


def ingest_into(params: Params, target: torch.Tensor, bins, cols,
                raw_bytes: torch.Tensor) -> None:
    """Ingest K items' chunk bytes and write their limbs in place into
    ``target`` (the dense DB tensor or the compact planes) at num_per bin
    bins[k] and column cols[k]; the (bin, column) pairs are distinct. One
    launch of kernel H on a CUDA tensor; ingest_plain + db_write_items on a
    CPU tensor."""
    if target.device.type == "cuda":
        _ingest_launch(params, raw_bytes, target, bins, cols)
    elif target.device.type == "cpu":
        db_write_items(params, target, bins, cols,
                       ingest_plain(params, raw_bytes))
    else:
        raise ValueError(f"unsupported device {target.device}")


class CompactSlots:
    """Host bookkeeping for the CompactDb layout: item index -> per-bin
    slot (copied from sdk_tpu.kv.ingest.CompactSlots; the compact analog of
    the reference SparseDb's id->offset map, db/sparse_db.rs:14-27). Slots
    are handed out in order and never freed, so a re-upserted item keeps
    its slot."""

    def __init__(self, params: Params, cap_bin: int = 8):
        self.num_per = 1 << params.db_dim_2
        self.dim0 = 1 << params.db_dim_1
        self.cap_bin = cap_bin
        self.slot_of: dict[int, int] = {}        # item idx -> slot in its bin
        self.bin_count = np.zeros(self.num_per, dtype=np.int64)

    def assign(self, idxs):
        """Assign slots for item idxs; returns (bins, slots, jvals, new_cap)
        where new_cap > cap_bin iff the planes must grow first."""
        bins = np.array([i % self.num_per for i in idxs], dtype=np.int64)
        jvals = np.array([i // self.num_per for i in idxs], dtype=np.int64)
        slots = np.empty(len(idxs), dtype=np.int64)
        for n, idx in enumerate(idxs):
            s = self.slot_of.get(idx)
            if s is None:
                b = int(bins[n])
                s = int(self.bin_count[b])
                self.bin_count[b] += 1
                self.slot_of[idx] = s
            slots[n] = s
        new_cap = self.cap_bin
        need = int(self.bin_count.max(initial=0))
        while new_cap < need:
            new_cap *= 2
        return bins, slots, jvals, min(new_cap, self.dim0)

    def clear(self) -> None:
        self.slot_of.clear()
        self.bin_count[:] = 0

    def to_state(self) -> dict:
        return {"cap_bin": self.cap_bin,
                "slot_of": {str(k): v for k, v in self.slot_of.items()}}

    def load_state(self, state: dict) -> None:
        self.cap_bin = state["cap_bin"]
        self.slot_of = {int(k): v for k, v in state["slot_of"].items()}
        self.bin_count[:] = 0
        for idx in self.slot_of:
            self.bin_count[idx % self.num_per] += 1


def compact_grow(params: Params, db: CompactDb, new_cap: int) -> CompactDb:
    """Pad a CompactDb's slot axis with zeros to new_cap (a multiple of 4;
    capacity-quantized growth, sdk_tpu/kv/ingest.py:146-158)."""
    cw = db.planes.shape[3]
    if new_cap <= 4 * cw:
        return db
    planes = torch.zeros(compact_shape(params, new_cap), dtype=torch.int8,
                         device=db.planes.device)
    planes[:, :, :, :cw] = db.planes
    idx_j = torch.nn.functional.pad(db.idx_j, (0, new_cap - 4 * cw))
    return CompactDb(planes, idx_j)


def _bin_counts(db: CompactDb, counts) -> torch.Tensor:
    npr = db.idx_j.shape[0]
    counts = torch.as_tensor(np.asarray(counts, dtype=np.int64)).to(
        device=db.idx_j.device, dtype=torch.int32)
    if tuple(counts.shape) != (npr,):
        raise ValueError(f"compact_to_dense: {npr} bin counts wanted, got "
                         f"{tuple(counts.shape)}")
    return counts


def compact_to_dense_plain(params: Params, db: CompactDb,
                           counts) -> torch.Tensor:
    """compact_to_dense in plain PyTorch: a scatter-ADD of every occupied
    slot onto its (bin, dim0) column of a zeroed dense tensor
    (sdk_tpu/kv/ingest.py:161-193), one (channel, limb) plane at a time, so
    the peak is the dense tensor + the compact one + one eighth of it."""
    planes, idx_j = db
    npr, cap = idx_j.shape
    dev = planes.device
    counts = _bin_counts(db, counts).to(torch.int64)
    dense = torch.zeros(db_shape(params), dtype=torch.int8, device=dev)
    dv = dense.view(dense.shape[:4] + (-1, npr, 4))   # (crt,z,L,jw,it,npr,4)
    cv = planes.view(planes.shape[:4] + (-1, npr, 4))
    b = torch.arange(npr, device=dev).repeat_interleave(cap)
    s = torch.arange(cap, device=dev).repeat(npr)
    occupied = s < counts.clamp(max=cap).repeat_interleave(cap)
    b, s = b[occupied], s[occupied]
    j = idx_j[b, s].to(torch.int64)
    for c in range(params.crt_count):
        for k in range(NUM_LIMBS):
            vals = cv[c, :, k][:, s // 4, :, b, s % 4]     # (n, z, it)
            dv[c, :, k].permute(1, 3, 4, 0, 2).index_put_(
                (j // 4, b, j % 4), vals, accumulate=True)
    return dense


# shared memory of a kernel H' block: the dense tile it assembles, its
# list of slots (4 bytes a slot) and each of its two row stages
MIGRATE_TILE_BYTES = 64 * 1024
MIGRATE_LIST_BYTES = 32 * 1024
MIGRATE_STAGE_BYTES = 16 * 1024
_MAX_SMEM = 226 * 1024


class MigrateTiling(NamedTuple):
    """A kernel H' block's tile (csrc/compact_to_dense.cu): it_t chunks x
    jw_t column words of every (c, z, l) row, staging the first cw_used slot
    words of each compact row; its slot list holds list_max slots."""
    it_t: int
    jw_t: int
    cw_used: int
    list_max: int


def migrate_tiling(cw: int, jw: int, it_n: int, npr: int,
                   max_count: int) -> MigrateTiling:
    """The widest power-of-two tile, column words first, whose dense tile,
    slot list and row stage fit their budgets (at least the 16 bytes of a
    store a column word: it_t * npr >= 4); max_count, the fullest bin's
    occupied slots, bounds the slot words staged and a bin's slots in the
    list."""
    cw_used = min(cw, -(-max(0, max_count) // 4))
    it_t = max(1, 4 // npr)
    if it_n % it_t or npr & (npr - 1) or jw & (jw - 1):
        raise ValueError(f"compact_to_dense: no tile of {it_n} chunks x "
                         f"{npr} bins x {jw} column words")

    def fits(it, jwt):
        return (jwt * it * npr * 4 <= MIGRATE_TILE_BYTES
                and 4 * npr * min(4 * cw_used, 4 * jwt) <= MIGRATE_LIST_BYTES)

    jw_t = 1
    while 2 * jw_t <= jw and fits(it_t, 2 * jw_t):
        jw_t *= 2
    while (it_n % (2 * it_t) == 0 and fits(2 * it_t, jw_t)
           and cw_used * 2 * it_t * npr * 4 <= MIGRATE_STAGE_BYTES):
        it_t *= 2
    tile = jw_t * it_t * npr * 4
    stage = cw_used * it_t * npr * 4
    list_max = npr * min(4 * cw_used, 4 * jw_t)
    smem = tile + -(-4 * list_max // 16) * 16 + 2 * stage
    if tile > 65536 or stage > 65536 or smem > _MAX_SMEM:
        raise ValueError(f"compact_to_dense: a tile needs {smem} bytes of "
                         f"shared memory")
    return MigrateTiling(it_t, jw_t, cw_used, list_max)


def _compact_to_dense_launch(params: Params, db: CompactDb,
                             counts) -> torch.Tensor:
    """Kernel H' (csrc/compact_to_dense.cu): one launch writes every byte
    of a new dense tensor, a tile of migrate_tiling a block."""
    planes, idx_j = db
    crt, z, L, cw, inst, trials, npr, four = planes.shape
    want = compact_shape(params, 4 * cw)
    if (planes.dtype != torch.int8 or idx_j.dtype != torch.int32
            or tuple(planes.shape) != want
            or tuple(idx_j.shape) != (npr, 4 * cw)
            or planes.data_ptr() % 16):          # 16-byte cp.async copies
        raise ValueError(f"compact_to_dense: planes {planes.dtype} "
                         f"{tuple(planes.shape)}, idx_j {idx_j.dtype} "
                         f"{tuple(idx_j.shape)}")
    max_count = int(np.max(np.asarray(counts), initial=0))
    counts = _bin_counts(db, counts)
    shape = db_shape(params)
    jw = shape[3]
    tl = migrate_tiling(cw, jw, inst * trials, npr, max_count)
    dense = torch.empty(shape, dtype=torch.int8, device=planes.device)
    _build.require_cuda(planes, idx_j, counts, dense)
    _build.launch("compact_to_dense", "sdk_compact_to_dense", planes.device,
                  planes.data_ptr(), idx_j.data_ptr(), counts.data_ptr(),
                  dense.data_ptr(), crt * z * L, cw, tl.cw_used, jw,
                  inst * trials, log2_exact(npr), log2_exact(tl.it_t),
                  log2_exact(tl.jw_t), tl.list_max, _build.stream_of(planes))
    return dense


def compact_to_dense(params: Params, db: CompactDb, counts) -> torch.Tensor:
    """Migrate a compact index to a new dense DB tensor on its device:
    the occupied slot s < counts[b] of every bin b lands on its dim0 column
    idx_j[b, s], and every other entry is zero. ``counts`` holds each bin's
    occupied slots (CompactSlots.bin_count): unoccupied slots carry idx_j 0,
    which a store must not place. Kernel H' on a CUDA tensor,
    compact_to_dense_plain on a CPU tensor; the caller drops the compact
    index."""
    device = db.planes.device
    if device.type == "cuda":
        return _compact_to_dense_launch(params, db, counts)
    if device.type == "cpu":
        return compact_to_dense_plain(params, db, counts)
    raise ValueError(f"unsupported device {device}")


class DbUpdateBuffer:
    """Host-side buffer of pending item rows, flushed as device ingest +
    in-place scatter into the dense DB tensor or the CompactDb (slot
    bookkeeping in self.slots)."""

    def __init__(self, params: Params, device):
        self.params = params
        self.device = torch.device(device)
        self.pending_raw: dict[int, np.ndarray] = {}
        self.slots = CompactSlots(params)

    def upsert_raw(self, db_idx: int, data: bytes) -> None:
        """Queue raw (compressed-row) bytes; the NTT encode runs on the
        device at flush time."""
        params = self.params
        if not 0 <= db_idx < params.num_items():
            raise ValueError(f"bad db idx {db_idx}")
        n_chunks = params.instances * params.n * params.n
        pt_len = params.bytes_per_chunk()
        buf = np.zeros(n_chunks * pt_len, dtype=np.uint8)
        arr = np.frombuffer(data, dtype=np.uint8)
        buf[: len(arr)] = arr
        self.pending_raw[db_idx] = buf.reshape(n_chunks, pt_len)

    def flush(self, db):
        """Apply all pending rows to ``db`` and return it: the same dense
        tensor or ShardedDb, or a CompactDb (a new one when its slot axis
        had to grow).

        The JAX engine donates the DB buffers to a scatter program and swaps
        in the result; here the scatter writes straight into the resident
        tensors (the compact planes and idx_j too). That is safe without
        donation or copies because every read and every flush is enqueued
        on the same CUDA stream, so the stream orders this write after the
        scans already in flight and before the ones dispatched later. Rows
        go through in chunks of FLUSH_CHUNK_ITEMS, one launch of kernel H
        each, which writes the limbs straight into the index."""
        if not self.pending_raw:
            return db
        params = self.params
        num_per = 1 << params.db_dim_2
        idxs = sorted(self.pending_raw)
        if isinstance(db, CompactDb):
            # the device tensor's slot capacity is authoritative
            self.slots.cap_bin = db.cap_bin
            bins, cols, jvals, new_cap = self.slots.assign(idxs)
            if new_cap > self.slots.cap_bin:
                db = compact_grow(params, db, new_cap)
                self.slots.cap_bin = new_cap
            target = db.planes
            db.idx_j[torch.from_numpy(bins).to(self.device),
                     torch.from_numpy(cols).to(self.device)] = \
                torch.from_numpy(jvals.astype(np.int32)).to(self.device)
        else:
            target = db
            bins = np.array([i % num_per for i in idxs], dtype=np.int64)
            cols = np.array([i // num_per for i in idxs], dtype=np.int64)
        for s in range(0, len(idxs), FLUSH_CHUNK_ITEMS):
            e = s + FLUSH_CHUNK_ITEMS
            raw = np.stack([self.pending_raw[i] for i in idxs[s:e]])
            if isinstance(db, ShardedDb):
                _flush_sharded(params, db, bins[s:e], cols[s:e], raw)
            else:
                ingest_into(params, target, bins[s:e], cols[s:e],
                            torch.from_numpy(raw).to(self.device))
        self.pending_raw.clear()
        return db


def _flush_sharded(params: Params, db: ShardedDb, bins, cols,
                   raw: np.ndarray) -> None:
    """Route K items to the shards that hold them: shard (g, j) takes the
    items whose dim0 column falls in its block, at local column col - j *
    dim0_local, and the chunk bytes of its trials (one launch of kernel H
    per shard that receives items)."""
    inst, trials = params.instances, params.n * params.n
    d0 = 4 * db.jw_l
    by_trial = raw.reshape(raw.shape[0], inst, trials, raw.shape[-1])
    for g, row in enumerate(db.shards):
        mine = by_trial[:, :, g * db.t_l:(g + 1) * db.t_l]
        for j, shard in enumerate(row):
            sel = cols // d0 == j
            if not sel.any():
                continue
            part = np.ascontiguousarray(mine[sel]).reshape(
                int(sel.sum()), inst * db.t_l, raw.shape[-1])
            ingest_into(params, shard, bins[sel], cols[sel] - j * d0,
                        torch.from_numpy(part).to(shard.device))
