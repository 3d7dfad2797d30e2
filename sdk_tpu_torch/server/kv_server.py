"""Server state machine for one bucket: rows, public params and the
encrypted index on the device.

Ports sdk_tpu/server/kv_server.py (reference bin/server.rs:22-29 and its
routes' semantics) onto SpiralServerTorch, with the JAX bucket's index
lifecycle: a new bucket starts in the O(populated) compact index, expands
queries sparsely while few first-dim rows are populated, and migrates to
the dense index once more than dense_migrate_fill of the items are
populated; with the key storage policies (bloom filter, key list), clear,
rename, destroy, metrics and checkpoint / restore of the encrypted index.
With a mesh (ops/shard.py) the bucket serves from a dense index cut over the
mesh's devices from the start, as the JAX bucket does (kv_server.py:92-97).
"""

from __future__ import annotations

import base64
import contextlib
import json
import logging
import os
import pickle
import threading
import time
import uuid as uuidlib

import numpy as np
import torch

from ..client import Client, PublicParameters, Query
from ..kv.key_value import row_from_key
from ..kv.write import compress_row, unwrap_kv_pairs, update_row
from ..params import Params, params_to_json_obj

from ..clients.bloom import BloomFilter
from ..kv.ingest import CompactSlots, DbUpdateBuffer, compact_to_dense
from ..ops.server import (SpiralServerTorch, index_hbm_bytes, pp_to_device,
                          serving_working_set_bytes)
from ..ops.shard import Mesh, ShardedDb, check_mesh
from ..ops.spiral import (CompactDb, compact_db_empty, compact_shape,
                          db_shape)
from ..telemetry import GLOBAL_TIMERS

UUID_V4_STR_BYTES = 36
# batch size the capacity guard sizes the serving working set for
CAPACITY_NQ = 16


class BucketCapacityError(RuntimeError):
    """The dense encrypted index + serving working set exceed the device
    memory budget. Raised BEFORE the allocation that would fail."""


class SpiralKvServerTorch:
    """One bucket: Spiral params + rows + encrypted index on ``device``, or
    on the devices of ``mesh`` (then ``device`` is the mesh's home)."""

    def __init__(self, params: Params, device="cuda",
                 params_json: str | None = None,
                 hbm_budget_bytes: int | None = None,
                 key_storage_policy: str = "bloom",
                 mesh: Mesh | None = None):
        self.params = params
        self.mesh = check_mesh(mesh)
        self.device = mesh.home if mesh is not None else torch.device(device)
        self.params_json = params_json or json.dumps(params_to_json_obj(params))
        self.name = ""
        self.destroyed = False
        # key storage policy: 'none' | 'bloom' | 'full' (reference
        # bucket_service.ts keyStoragePolicy); the bloom filter is the
        # prefilter of the clients' private_key_intersect
        if key_storage_policy not in ("none", "bloom", "full"):
            raise ValueError(f"key_storage_policy {key_storage_policy!r}")
        self.key_storage_policy = key_storage_policy
        self._key_bloom = None
        self._stored_keys: set[str] = set()
        if key_storage_policy in ("bloom", "full"):
            self._key_bloom = BloomFilter.empty(
                8, params.db_dim_1 + params.db_dim_2 + 6)
        self.rows: list[bytearray] = [bytearray()
                                      for _ in range(params.num_items())]
        self.pub_params: dict[str, dict] = {}
        self.version = 0
        self.lock = threading.RLock()
        # device-memory budget of the capacity guard: None = the device's
        # free memory (torch.cuda.mem_get_info); no guard on the CPU
        self.hbm_budget_bytes = hbm_budget_bytes
        self.engine = SpiralServerTorch(params, self.device, mesh=mesh)
        # The bucket starts in the O(populated) CompactDb layout (the
        # reference SparseDb's memory model, db/sparse_db.rs:1-48) and
        # migrates to the dense index once more than dense_migrate_fill of
        # the items are populated. The thresholds are the JAX bucket's
        # (kv_server.py:71-110). Neither changes a response (a compact
        # index and sparse expansion give the dense path's bytes); they
        # choose the device work and memory, and their speed on this card
        # is not claimed.
        # A sharded bucket is dense from the start: the index is cut over
        # the mesh, with no compact index and no migration.
        self.dense_migrate_fill = 0.125
        self._migration_refused = False
        if mesh is not None:
            self._check_capacity()
            self.engine.set_db(ShardedDb.zeros(params, mesh))
        else:
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
        if os.environ.get("SDK_TPU_NO_CAPACITY_GUARD"):
            return None
        if self.hbm_budget_bytes is not None:
            return self.hbm_budget_bytes
        env = os.environ.get("SDK_TPU_HBM_BUDGET_BYTES")
        if env:
            return int(env)
        if self.device.type != "cuda":
            return None
        free, _total = torch.cuda.mem_get_info(self.device)
        return free

    def _check_capacity(self) -> None:
        """Refuse a dense index that cannot fit next to its serving working
        set, before allocating it. A mesh divides the index over its "db"
        axis (kv_server.py:148-150); the error names the escape hatches."""
        budget = self._device_budget_bytes()
        if budget is None:
            return
        params = self.params
        ndev = self.mesh.shape["db"] if self.mesh is not None else 1
        idx = index_hbm_bytes(params) // ndev
        ws = serving_working_set_bytes(params, nq=CAPACITY_NQ)
        if idx + ws <= budget:
            return
        per_item = index_hbm_bytes(params) // params.num_items()
        max_items = max((budget - ws) * ndev // per_item, 0)
        raise BucketCapacityError(
            f"dense index needs {idx / 1e9:.2f} GB/device + {ws / 1e9:.2f} "
            f"GB serving working set, but the device budget is "
            f"{budget / 1e9:.2f} GB. Max bucket at these params on this "
            f"budget: ~{max_items} items "
            f"({max_items * params.db_item_size / 1e9:.2f} GB of "
            f"{params.db_item_size}-byte items). Escape hatches: serve from "
            f"a sharded mesh (SpiralKvServerTorch(mesh=...), rows split over "
            f"the 'db' axis) or split the bucket across hosts behind the DCN "
            f"front end (sdk_tpu_torch.server.dcn).")

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
                    if v and self._key_bloom is not None:
                        self._key_bloom.insert(k)
                    if v and self.key_storage_policy == "full":
                        self._stored_keys.add(k)
                    elif not v:
                        self._stored_keys.discard(k)
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
        written, write them, then resolve the sparse-expansion set. The
        engine's ``index_rows`` becomes the rows written (the populated
        items), whichever layout holds them. Traced as the span
        ``bucket.flush`` (count: the pending rows)."""
        with GLOBAL_TIMERS.span("bucket.flush",
                                len(self._updates.pending_raw)):
            params = self.params
            if (isinstance(self.engine.db, CompactDb)
                    and not self._migration_refused
                    and len(self._populated_items)
                    > self.dense_migrate_fill * params.num_items()):
                try:
                    self._check_capacity()
                except BucketCapacityError as e:
                    # the compact index serves any fill, so a bucket that
                    # cannot afford the dense one stays compact and keeps
                    # serving: the flush runs on the read path, which must
                    # not raise
                    logging.getLogger(__name__).warning(
                        "dense migration refused; serving stays compact: %s",
                        e)
                    self._migration_refused = True
                else:
                    self.engine.set_db(compact_to_dense(
                        params, self.engine.db, self._updates.slots.bin_count))
                    self._updates.slots.clear()
            self.engine.db = self._updates.flush(self.engine.db)
            self.engine.index_rows = len(self._populated_items)
            if self._pop_dirty:
                dim0 = 1 << params.db_dim_1
                dim0_set = {i >> params.db_dim_2
                            for i in self._populated_items}
                use = 0 < len(dim0_set) <= int(
                    dim0 * self.sparse_expansion_max_fill)
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

    def has_uuid(self, uid: str) -> bool:
        return uid in self.pub_params

    def _parse_request(self, request_bytes: bytes):
        """A request blob -> (device key dict, Query): a session's uuid and
        its query, or, for direct-upload params, the public params inline
        before the query (kv_server.py:285-300), keyed anew for each
        request."""
        params = self.params
        head = (UUID_V4_STR_BYTES if params.expand_queries
                else params.setup_bytes())
        want = head + params.query_bytes()
        if len(request_bytes) != want:
            raise ValueError(f"request: {len(request_bytes)} bytes, want "
                             f"{want}")
        if params.expand_queries:
            uid = request_bytes[:head].decode()
            if uid not in self.pub_params:
                raise KeyError(uid)
            pp_dev = self.pub_params[uid]
        else:
            pp = PublicParameters.deserialize(params, request_bytes[:head])
            pp_dev = pp_to_device(params, pp, self.device)
        return pp_dev, Query.deserialize(params, request_bytes[head:])

    def _parse_requests(self, blobs: list[bytes]) -> list:
        """_parse_request of each blob, traced as the span ``bucket.parse``
        (count: the blobs)."""
        with GLOBAL_TIMERS.span("bucket.parse", len(blobs)):
            return [self._parse_request(b) for b in blobs]

    @contextlib.contextmanager
    def _read_lock(self):
        """The bucket's lock on the read path; the wait for it is the span
        ``bucket.lock_wait``."""
        with GLOBAL_TIMERS.span("bucket.lock_wait"):
            self.lock.acquire()
        try:
            yield
        finally:
            self.lock.release()

    def private_read_one(self, request_bytes: bytes) -> bytes:
        with self._read_lock():
            self._flush()
            [(pp_dev, query)] = self._parse_requests([request_bytes])
            return self.engine.process_query(pp_dev, query)

    def private_read_blobs(self, blobs: list[bytes]) -> list[bytes]:
        """Raw request blobs -> response bytes; one shared DB scan."""
        return self.dispatch_read_blobs(blobs)()

    def dispatch_read_blobs(self, blobs: list[bytes]):
        """Two-phase read: enqueue the batch on the device under the lock
        and return a zero-arg fetch closure, which callers may run outside
        the lock. A flush between a dispatch and its fetch is safe: it is
        enqueued on the same stream, after the batch's scan."""
        with self._read_lock():
            self._flush()
            return self.engine.dispatch_queries_batched(
                self._parse_requests(blobs))

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
        it after the initial writes. A direct-upload bucket's round carries
        its public params inline (kv_server.py:350-359). Returns elapsed
        seconds."""
        t0 = time.monotonic()
        client = Client(self.params)
        setup = client.generate_keys().serialize(self.params)
        qbytes = client.generate_query(0).serialize(self.params)
        if not self.params.expand_queries:
            self.private_read_blobs([setup + qbytes])
            return time.monotonic() - t0
        uid = self.setup_raw(setup)
        try:
            self.private_read_blobs([uid.encode() + qbytes])
        finally:
            with self.lock:
                self.pub_params.pop(uid, None)
        return time.monotonic() - t0

    def bloom_bytes(self) -> bytes:
        if self._key_bloom is None:
            raise KeyError("bloom")
        return self._key_bloom.to_bytes()

    def list_keys(self) -> list[str]:
        if self.key_storage_policy != "full":
            raise KeyError("list-keys")
        return sorted(self._stored_keys)

    def clear(self) -> None:
        """Delete all rows but keep metadata and public params (reference
        clear_entire_bucket semantics): back to a fresh minimal compact
        index, which releases the dense tensor if the bucket had migrated."""
        with self.lock:
            for r in self.rows:
                r.clear()
            if self.mesh is not None:
                self.engine.db.zero_()  # a sharded index is zeroed in place
            else:
                self.engine.db = None   # drop the old index before the new
                self.engine.set_db(compact_db_empty(self.params, self.device))
            self._updates.slots = CompactSlots(self.params)
            self._updates.pending_raw.clear()
            self._populated_items.clear()
            self._pop_dirty = False
            self._migration_refused = False
            self.engine.set_populated_dim0(None)
            self._stored_keys.clear()
            if self._key_bloom is not None:
                self._key_bloom = BloomFilter.empty(self._key_bloom.k,
                                                    self._key_bloom.bits)
            self.version += 1

    def rename(self, new_name: str) -> None:
        """Bucket rename (reference /modify route, js bucket.ts rename)."""
        with self.lock:
            self.name = new_name

    def destroy(self) -> None:
        """Destroy the bucket entirely: all state gone, subsequent requests
        404 (reference destroy_entire_bucket semantics; this single-bucket
        server tombstones it)."""
        with self.lock:
            self.clear()
            self.pub_params.clear()
            self.destroyed = True

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

    def metrics(self) -> dict:
        """Span totals, the version, the rows holding key-value data, and
        the index's device bytes and compact capacity (``cap_bin``, None
        when dense)."""
        db = self.engine.db
        compact = isinstance(db, CompactDb)
        return {"stages": GLOBAL_TIMERS.snapshot(), "version": self.version,
                "num_rows_populated": sum(1 for r in self.rows if r),
                "index_bytes": (db.planes.numel() if compact
                                else 0 if db is None
                                else index_hbm_bytes(self.params)),
                "cap_bin": db.cap_bin if compact else None}

    # --- checkpoint / restore of the preprocessed encrypted index ---
    # (reference: load_preprocessed_db_from_file, db/loading.rs:263-276)

    def save_to_dir(self, path: str) -> None:
        """Write db_tensor.npy (the dense DB tensor or the compact planes in
        the port's layout, spiral.db_shape / compact_shape), db_idx_j.npy
        (compact), rows.pkl and state.json. The index streams to the file
        one (channel, z-block) slice at a time through a memmap, so neither
        the host nor the device holds a second copy. A sharded index is
        saved whole, in the same format: its checkpoint restores into an
        unsharded bucket, and the other way round."""
        os.makedirs(path, exist_ok=True)
        with self.lock:
            self._flush()
            compact = isinstance(self.engine.db, CompactDb)
            planes = self.engine.db.planes if compact else self.engine.db
            out = np.lib.format.open_memmap(
                os.path.join(path, "db_tensor.npy"), mode="w+",
                dtype=np.int8, shape=tuple(planes.shape))
            step = _z_step(planes)
            for c in range(planes.shape[0]):
                for z0 in range(0, planes.shape[1], step):
                    blk = (planes.read_slice(c, z0, z0 + step)
                           if isinstance(planes, ShardedDb)
                           else planes[c, z0:z0 + step].cpu())
                    out[c, z0:z0 + step] = blk.numpy()
            out.flush()
            del out
            if compact:
                np.save(os.path.join(path, "db_idx_j.npy"),
                        self.engine.db.idx_j.cpu().numpy())
            with open(os.path.join(path, "rows.pkl"), "wb") as f:
                pickle.dump([bytes(r) for r in self.rows], f)
            state = {"version": self.version,
                     "params_json": self.params_json,
                     "key_storage_policy": self.key_storage_policy,
                     "stored_keys": sorted(self._stored_keys),
                     "populated_items": sorted(self._populated_items),
                     "db_format": "compact" if compact else "dense",
                     "db_layout": "torch"}
            if compact:
                state["compact_slots"] = self._updates.slots.to_state()
            if self._key_bloom is not None:
                state["key_bloom"] = self._key_bloom.to_bytes().hex()
            with open(os.path.join(path, "state.json"), "w") as f:
                json.dump(state, f)

    def _load_index(self, db: np.ndarray, compact: bool):
        """db_tensor.npy (a memmap) -> the index tensor on the device, in
        the port's layout. Takes the port's own checkpoints (ndim 8) and the
        JAX bucket's plane format (crt*L stacked int8 planes (z, inst,
        trials, num_per, cols), ndim 6), regrouped slice by slice on the host. The
        JAX bucket's other formats are layouts of its TPU build and are
        refused."""
        params = self.params
        if db.ndim == 7:
            raise ValueError(
                "checkpoint is in the JAX bucket's 'throughput' dense layout "
                "(crt, z, inst, trials, num_per, L, dim0), a TPU layout that "
                "the port does not read; save it in the 'latency' layout")
        if db.ndim == 6 and db.dtype == np.uint32:
            raise ValueError(
                "checkpoint is in the JAX bucket's legacy pre-limb uint32 "
                "format (inst, trials, crt, z, num_per, dim0), which the "
                "port does not read")
        if db.dtype != np.int8 or db.ndim not in (6, 8):
            raise ValueError(f"unknown db_tensor.npy format {db.dtype} "
                             f"{db.shape}")
        jax_planes = db.ndim == 6
        cols = db.shape[-1] if jax_planes else 4 * db.shape[3]
        if cols % 4:
            raise ValueError(f"checkpoint has {cols} columns per bin; the "
                             f"port's index holds them in words of 4")
        want = compact_shape(params, cols) if compact else db_shape(params)
        crt, z, L, jw = want[:4]
        have = ((crt * L, z) + want[4:7] + (cols,)) if jax_planes else want
        if tuple(db.shape) != have:
            raise ValueError(f"checkpoint index {db.shape}, want {have}")
        if self.mesh is not None:
            # re-shard: each slice goes to the shards that hold it
            dev = ShardedDb.zeros(params, self.mesh)
        else:
            dev = torch.empty(want, dtype=torch.int8, device=self.device)
        step = _z_step(dev)
        for c in range(crt):
            for z0 in range(0, z, step):
                if jax_planes:
                    # (L, zb, inst, trials, npr, jw, 4) -> (zb, L, jw, ...)
                    blk = np.stack([db[c * L + k, z0:z0 + step]
                                    for k in range(L)])
                    blk = blk.reshape(blk.shape[:-1] + (jw, 4)).transpose(
                        1, 0, 5, 2, 3, 4, 6)
                    blk = np.ascontiguousarray(blk)
                else:
                    blk = np.array(db[c, z0:z0 + step])   # off the memmap
                if isinstance(dev, ShardedDb):
                    dev.write_slice_(c, z0, z0 + step, torch.from_numpy(blk))
                else:
                    dev[c, z0:z0 + step] = torch.from_numpy(blk)
        return dev

    def restore_from_dir(self, path: str) -> None:
        with self.lock:
            with open(os.path.join(path, "state.json")) as f:
                state = json.load(f)
            compact = state.get("db_format") == "compact"
            if compact and self.mesh is not None:
                raise ValueError("a compact checkpoint does not restore into "
                                 "a sharded bucket, which serves dense")
            self._migration_refused = False
            # memmap: the index streams file -> device instead of being
            # materialised in host memory first
            db = np.load(os.path.join(path, "db_tensor.npy"), mmap_mode="r")
            if not compact:
                self._check_capacity()   # refuse before allocating
            # release the resident index before uploading the new one:
            # holding both would need twice the index bytes for a while
            self.engine.db = None
            try:
                index = self._load_index(db, compact)
                if compact:
                    idx_j = torch.from_numpy(np.load(
                        os.path.join(path, "db_idx_j.npy")).astype(np.int32))
                    slots = CompactSlots(self.params)
                    slots.load_state(state["compact_slots"])
                    if slots.cap_bin != idx_j.shape[1]:
                        raise ValueError("compact_slots and db_idx_j.npy "
                                         "disagree on cap_bin")
                    self.engine.set_db(CompactDb(index, idx_j))
                    self._updates.slots = slots
                else:
                    self.engine.set_db(index)
                    self._updates.slots = CompactSlots(self.params)
            except Exception:
                self.engine.set_db(
                    ShardedDb.zeros(self.params, self.mesh)
                    if self.mesh is not None
                    else compact_db_empty(self.params, self.device))
                raise
            with open(os.path.join(path, "rows.pkl"), "rb") as f:
                self.rows = [bytearray(r) for r in pickle.load(f)]
            self.version = state["version"]
            self._stored_keys = set(state.get("stored_keys", []))
            if "populated_items" in state:
                self._populated_items = set(state["populated_items"])
                self._pop_dirty = True
            else:
                # older checkpoint: no population info, so expand densely
                self._populated_items = set()
                self._pop_dirty = False
                self.engine.set_populated_dim0(None)
            if "key_bloom" in state and self._key_bloom is not None:
                # a writable copy: the bucket goes on inserting keys
                loaded = BloomFilter.from_bytes(
                    bytes.fromhex(state["key_bloom"]))
                self._key_bloom = BloomFilter(loaded.k, loaded.bits,
                                              bytearray(loaded.data))
            self._updates.pending_raw.clear()


def _z_step(index: torch.Tensor) -> int:
    """z rows per streamed checkpoint slice: about 64 MB of the index."""
    per_z = int(np.prod(index.shape[2:], dtype=np.int64))
    return max(1, min(index.shape[1], (64 << 20) // max(per_z, 1)))
