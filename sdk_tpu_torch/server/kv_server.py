"""Server state machine for one bucket: rows, public params and the
encrypted index on the device.

Ports sdk_tpu/server/kv_server.py (reference bin/server.rs:22-29 and its
routes' semantics) onto SpiralServerTorch, with the JAX bucket's index
lifecycle: a new bucket starts in the O(populated) compact index, expands
queries sparsely while few first-dim rows are populated, and migrates to
the dense index once more than dense_migrate_fill of the items are
populated. Sharding, checkpointing, clear and the key storage policies
(bloom filter, key list) are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import uuid as uuidlib

import torch

from ..client import Client, PublicParameters, Query
from ..kv.key_value import row_from_key
from ..kv.write import compress_row, unwrap_kv_pairs, update_row
from ..params import Params, params_to_json_obj

from ..kv.ingest import DbUpdateBuffer, compact_to_dense
from ..ops.server import (SpiralServerTorch, index_hbm_bytes, pp_to_device,
                          serving_working_set_bytes)
from ..ops.spiral import CompactDb, compact_db_empty

UUID_V4_STR_BYTES = 36
# batch size the capacity guard sizes the serving working set for
CAPACITY_NQ = 16


class BucketCapacityError(RuntimeError):
    """The dense encrypted index + serving working set exceed the device
    memory budget. Raised BEFORE the allocation that would fail."""


class SpiralKvServerTorch:
    """One bucket: Spiral params + rows + encrypted index on ``device``."""

    def __init__(self, params: Params, device="cuda",
                 params_json: str | None = None,
                 hbm_budget_bytes: int | None = None):
        self.params = params
        self.device = torch.device(device)
        self.params_json = params_json or json.dumps(params_to_json_obj(params))
        self.name = ""
        self.rows: list[bytearray] = [bytearray()
                                      for _ in range(params.num_items())]
        self.pub_params: dict[str, dict] = {}
        self.version = 0
        self.lock = threading.RLock()
        # device-memory budget of the capacity guard: None = the device's
        # free memory (torch.cuda.mem_get_info); no guard on the CPU
        self.hbm_budget_bytes = hbm_budget_bytes
        self.engine = SpiralServerTorch(params, self.device)
        # The bucket starts in the O(populated) CompactDb layout (the
        # reference SparseDb's memory model, db/sparse_db.rs:1-48) and
        # migrates to the dense index once more than dense_migrate_fill of
        # the items are populated. The thresholds are the JAX bucket's
        # (kv_server.py:71-110). Neither changes a response (a compact
        # index and sparse expansion give the dense path's bytes); they
        # choose the device work and memory, and their speed on this card
        # is not claimed.
        self.dense_migrate_fill = 0.125
        self._migration_refused = False
        self.engine.set_db(compact_db_empty(params, self.device))
        self._updates = DbUpdateBuffer(params, self.device)
        # populated item indices (an over-approximation of the nonzero DB
        # rows) drive the compacted sparse query expansion while at most
        # sparse_expansion_max_fill of the first-dim rows are populated
        self._populated_items: set[int] = set()
        self._pop_dirty = False
        self.sparse_expansion_max_fill = 0.25

    # --- capacity guard ---

    def _device_budget_bytes(self) -> int | None:
        if self.hbm_budget_bytes is not None:
            return self.hbm_budget_bytes
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return free

    def _check_capacity(self) -> None:
        """Refuse a dense index that cannot fit next to its serving working
        set, before allocating it."""
        budget = self._device_budget_bytes()
        if budget is None:
            return
        params = self.params
        idx = index_hbm_bytes(params)
        ws = serving_working_set_bytes(params, nq=CAPACITY_NQ)
        if idx + ws <= budget:
            return
        per_item = idx // params.num_items()
        max_items = max((budget - ws) // per_item, 0)
        raise BucketCapacityError(
            f"dense index needs {idx / 1e9:.2f} GB + {ws / 1e9:.2f} GB "
            f"serving working set, but the device budget is "
            f"{budget / 1e9:.2f} GB. Max bucket at these params on this "
            f"budget: ~{max_items} items "
            f"({max_items * params.db_item_size / 1e9:.2f} GB of "
            f"{params.db_item_size}-byte items).")

    # --- writes ---

    def write_kv(self, body: bytes) -> dict:
        t0 = time.time()
        with self.lock:
            by_row: dict[int, list[tuple[str, bytes]]] = {}
            for k, v in unwrap_kv_pairs(body):
                by_row.setdefault(row_from_key(len(self.rows), k),
                                  []).append((k, v))
            for row_id in sorted(by_row):
                for k, v in by_row[row_id]:
                    update_row(self.rows[row_id], k, v)
                self.update_item_raw(row_id, compress_row(self.rows[row_id]))
            self.version += 1
        return {"status": "done updating",
                "loading_time_us": int((time.time() - t0) * 1e6)}

    def update_item_raw(self, db_idx: int, data: bytes) -> None:
        params = self.params
        max_len = (params.instances * params.n * params.n
                   * params.bytes_per_chunk())
        if len(data) > max_len:
            raise ValueError(f"row {db_idx} data too large: "
                             f"{len(data)} > {max_len}")
        # the NTT encode runs on the device in batches at flush time
        with self.lock:
            self._updates.upsert_raw(db_idx, data)
            if db_idx not in self._populated_items:
                self._populated_items.add(db_idx)
                self._pop_dirty = True

    def update_item(self, body: bytes) -> None:
        """body = u32 idx BE || chunk bytes (loading.rs:301-316)."""
        db_idx = int.from_bytes(body[:4], "big")
        if db_idx >= self.params.num_items():
            raise ValueError(f"bad db idx {db_idx}")
        self.update_item_raw(db_idx, body[4:])

    def update_many_items(self, body: bytes) -> int:
        """Length-prefixed concatenation of update_item bodies
        (loading.rs:361-377). Returns the largest item's length."""
        offs = 0
        largest = 0
        with self.lock:
            while offs < len(body):
                chunk_len = int.from_bytes(body[offs:offs + 4], "big")
                data = body[offs + 4:offs + 4 + chunk_len]
                largest = max(largest, len(data))
                self.update_item(data)
                offs += 4 + chunk_len
        return largest

    def flush(self) -> None:
        """Write every pending row into the device index (reads flush
        first; bulk loaders may call this between batches of rows)."""
        with self.lock:
            self._flush()

    def _flush(self) -> None:
        """kv_server.py:225-265, step for step: decide the migration on the
        populated count (pending rows included) before the pending rows are
        written, write them, then resolve the sparse-expansion set."""
        params = self.params
        if (isinstance(self.engine.db, CompactDb)
                and not self._migration_refused
                and len(self._populated_items)
                > self.dense_migrate_fill * params.num_items()):
            try:
                self._check_capacity()
            except BucketCapacityError as e:
                # the compact index serves any fill, so a bucket that cannot
                # afford the dense one stays compact and keeps serving: the
                # flush runs on the read path, which must not raise
                logging.getLogger(__name__).warning(
                    "dense migration refused; serving stays compact: %s", e)
                self._migration_refused = True
            else:
                self.engine.set_db(compact_to_dense(params, self.engine.db))
                self._updates.slots.clear()
        self.engine.db = self._updates.flush(self.engine.db)
        if self._pop_dirty:
            dim0 = 1 << params.db_dim_1
            dim0_set = {i >> params.db_dim_2 for i in self._populated_items}
            use = 0 < len(dim0_set) <= int(dim0 * self.sparse_expansion_max_fill)
            self.engine.set_populated_dim0(dim0_set if use else None)
            self._pop_dirty = False

    # --- setup / read ---

    def setup_raw(self, raw: bytes, uid: str | None = None) -> str:
        if len(raw) != self.params.setup_bytes():
            raise ValueError(f"setup: {len(raw)} bytes, want "
                             f"{self.params.setup_bytes()}")
        pp = PublicParameters.deserialize(self.params, raw)
        uid = uid or str(uuidlib.uuid4())
        pp_dev = pp_to_device(self.params, pp, self.device)
        with self.lock:
            self.pub_params[uid] = pp_dev
        return uid

    def setup(self, body: bytes) -> str:
        """body: JSON string of base64 public params; returns a uuid."""
        return self.setup_raw(base64.b64decode(json.loads(body)))

    def _parse_request(self, request_bytes: bytes):
        params = self.params
        want = UUID_V4_STR_BYTES + params.query_bytes()
        if len(request_bytes) != want:
            raise ValueError(f"request: {len(request_bytes)} bytes, want "
                             f"{want}")
        uid = request_bytes[:UUID_V4_STR_BYTES].decode()
        if uid not in self.pub_params:
            raise KeyError(uid)
        query = Query.deserialize(params, request_bytes[UUID_V4_STR_BYTES:])
        return self.pub_params[uid], query

    def private_read_one(self, request_bytes: bytes) -> bytes:
        with self.lock:
            self._flush()
            pp_dev, query = self._parse_request(request_bytes)
            return self.engine.process_query(pp_dev, query)

    def private_read_blobs(self, blobs: list[bytes]) -> list[bytes]:
        """Raw request blobs -> response bytes; one shared DB scan."""
        return self.dispatch_read_blobs(blobs)()

    def dispatch_read_blobs(self, blobs: list[bytes]):
        """Two-phase read: enqueue the batch on the device under the lock
        and return a zero-arg fetch closure, which callers may run outside
        the lock. A flush between a dispatch and its fetch is safe: it is
        enqueued on the same stream, after the batch's scan."""
        with self.lock:
            self._flush()
            reqs = [self._parse_request(b) for b in blobs]
            return self.engine.dispatch_queries_batched(reqs)

    def private_read(self, body: bytes) -> bytes:
        """JSON list of base64 queries -> JSON list of base64 responses
        (bin/server.rs:143-163). Multi-query requests share one DB scan."""
        results = self.private_read_blobs(
            [base64.b64decode(qs) for qs in json.loads(body)])
        return json.dumps([base64.b64encode(r).decode()
                           for r in results]).encode()

    def warmup(self) -> float:
        """One synthetic protocol round (throwaway client keys -> setup ->
        query for row 0) through the real read path, so that the kernel
        build and first launches happen before traffic. It runs the index's
        current state (compact or dense, sparse or dense expansion), so call
        it after the initial writes. Returns elapsed seconds."""
        t0 = time.monotonic()
        client = Client(self.params)
        pp = client.generate_keys()
        qbytes = client.generate_query(0).serialize(self.params)
        uid = self.setup_raw(pp.serialize(self.params))
        try:
            self.private_read_blobs([uid.encode() + qbytes])
        finally:
            with self.lock:
                self.pub_params.pop(uid, None)
        return time.monotonic() - t0

    def meta(self) -> dict:
        return {
            "id": 0,
            "name": self.name,
            "owner_id": 0,
            "open_access": True,
            "pir_scheme": json.loads(self.params_json),
            "global_version": self.version,
            "index_layout": ("compact" if isinstance(self.engine.db, CompactDb)
                             else "dense"),
            "sparse_expansion": self.engine._splan is not None,
        }
