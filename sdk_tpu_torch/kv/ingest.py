"""DB ingestion on the device: row bytes -> NTT residues -> the index.

Ports sdk_tpu/kv/ingest.py (reference lib/server/src/db/loading.rs:278-377).
Each item splits into instances*n*n chunks; chunk bytes become mod-p
coefficients, are recentered into mod-Q, NTT'd (kernel group A) and
written, as 7-bit limbs, at the item's (dim0, num_per) coordinates of the
dense DB tensor, or at its (bin, slot) of the compact one
(spiral.CompactDb; slot bookkeeping in CompactSlots). compact_to_dense
migrates a compact index to the dense layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arith import log2_exact
from ..params import Params

from ..ops.ntt import ntt_forward
from ..ops.spiral import (NUM_LIMBS, CompactDb, compact_shape, db_shape,
                          db_write_items)

# items ingested per flush step: bounds the flush's device temporaries
# (~0.6 MB per item at the 1 GiB bucket) whatever the number pending
FLUSH_CHUNK_ITEMS = 1024


def ingest_items_device(params: Params, raw_bytes: torch.Tensor) -> torch.Tensor:
    """(K, instances*trials, bytes_per_chunk) uint8 zero-padded chunk bytes
    -> (K, instances*trials, crt, poly_len) int32 NTT residues, computed on
    raw_bytes' device. Any power-of-two p: logp-bit fields are read from
    each chunk's little-endian bitstream."""
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
    return ntt_forward(params, chans)


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


def compact_to_dense(params: Params, db: CompactDb) -> torch.Tensor:
    """Migrate a compact index to a new dense DB tensor on its device by
    scatter-ADD of every slot onto its (bin, dim0) column: the unoccupied
    slots add zeros (sdk_tpu/kv/ingest.py:161-193), so no occupancy mask is
    needed. One (channel, limb) plane at a time, so the peak is the dense
    tensor + the compact one + one eighth of the compact one; the caller
    drops the compact index."""
    planes, idx_j = db
    npr, cap = idx_j.shape
    dev = planes.device
    dense = torch.zeros(db_shape(params), dtype=torch.int8, device=dev)
    dv = dense.view(dense.shape[:4] + (-1, npr, 4))   # (crt,z,L,jw,it,npr,4)
    cv = planes.view(planes.shape[:4] + (-1, npr, 4))
    b = torch.arange(npr, device=dev).repeat_interleave(cap)
    s = torch.arange(cap, device=dev).repeat(npr)
    j = idx_j.reshape(-1).to(torch.int64)
    for c in range(params.crt_count):
        for k in range(NUM_LIMBS):
            vals = cv[c, :, k][:, s // 4, :, b, s % 4]     # (npr*cap, z, it)
            dv[c, :, k].permute(1, 3, 4, 0, 2).index_put_(
                (j // 4, b, j % 4), vals, accumulate=True)
    return dense


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
        tensor, or a CompactDb (a new one when its slot axis had to grow).

        The JAX engine donates the DB buffers to a scatter program and swaps
        in the result; here the scatter writes straight into the resident
        tensors (the compact planes and idx_j too). That is safe without
        donation or copies because every read and every flush is enqueued
        on the same CUDA stream, so the stream orders this write after the
        scans already in flight and before the ones dispatched later. The
        limb decompose runs on the device, and rows go through in chunks of
        FLUSH_CHUNK_ITEMS, so a full-bucket fill never holds a second
        index-sized temporary."""
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
            raw = torch.from_numpy(np.stack(
                [self.pending_raw[i] for i in idxs[s:e]])).to(self.device)
            db_write_items(params, target, bins[s:e], cols[s:e],
                           ingest_items_device(params, raw))
        self.pending_raw.clear()
        return db
