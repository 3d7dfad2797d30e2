"""DB ingestion on the device: row bytes -> NTT residues -> the dense index.

Ports the dense path of sdk_tpu/kv/ingest.py (reference
lib/server/src/db/loading.rs:278-377). Each item splits into
instances*n*n chunks; chunk bytes become mod-p coefficients, are recentered
into mod-Q, NTT'd (kernel group A) and written, as 7-bit limbs, at the
item's (dim0, num_per) coordinates of the DB tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from sdk_tpu.arith import log2_exact
from sdk_tpu.params import Params

from ..ops.ntt import ntt_forward
from ..ops.spiral import db_write_items

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


class DbUpdateBuffer:
    """Host-side buffer of pending item rows, flushed as device ingest +
    in-place scatter into the dense DB tensor."""

    def __init__(self, params: Params, device):
        self.params = params
        self.device = torch.device(device)
        self.pending_raw: dict[int, np.ndarray] = {}

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

    def flush(self, db: torch.Tensor) -> None:
        """Apply all pending rows to ``db`` IN PLACE.

        The JAX engine donates the DB buffer to a scatter program and swaps
        in the result; here the scatter writes straight into the resident
        tensor. That is safe without donation or copies because every read
        and every flush is enqueued on the same CUDA stream, so the stream
        orders this write after the scans already in flight and before the
        ones dispatched later. The limb decompose runs on the device, and
        rows go through in chunks of FLUSH_CHUNK_ITEMS, so a full-bucket
        fill never holds a second index-sized temporary."""
        idxs = sorted(self.pending_raw)
        for s in range(0, len(idxs), FLUSH_CHUNK_ITEMS):
            chunk = idxs[s:s + FLUSH_CHUNK_ITEMS]
            raw = torch.from_numpy(np.stack(
                [self.pending_raw[i] for i in chunk])).to(self.device)
            db_write_items(self.params, db, chunk,
                           ingest_items_device(self.params, raw))
        self.pending_raw.clear()
