"""Spiral server engine on PyTorch: device state and the query pipeline.

Ports sdk_tpu/ops/server_jax.py. Every stage of a read runs on the
engine's device: expansion (dense, or compacted sparse once a populated set
is installed) -> first-dim scan (dense or compact index) -> fold -> pack ->
encode; only the wire words come back to the host. A direct-upload query
(params.expand_queries false) carries its scan columns and GSW keys itself:
they are uploaded, and the keys go through kernel A, in place of the
expansion. With a mesh (ops/shard.py) the dense index is cut over the
mesh's devices: the scan runs per shard, kernel M sums each dp group's
partials, F folds per dp group, and expansion, pack and encode run on the
mesh's home device. While the CLIENT_TEST hook is set (debug_hooks), a
single read decrypts its folded ciphertext before the pack.
Reference pipeline: lib/server/src/server.rs:17-99,
lib/spiral-rs/src/server.rs:650-741.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import poly as hpoly
from ..client import PublicParameters, Query
from ..debug_hooks import check_folded_ct, client_test_active
from ..params import Params
from ..telemetry import GLOBAL_TIMERS

from ..convert import db_from_host_tensor
from . import spiral as sj
from .encode import ResponseEncodePlan
from .modops import shoup_companion_arr, to_device, u32_bits
from .shard import (Mesh, ShardedDb, ShardedSpiralScan, check_mesh,
                    fold_columns)


def db_tensor_to_device(params: Params, db_host: np.ndarray,
                        device) -> torch.Tensor:
    """Host DB tensor (inst, trials, poly_len, crt, num_per, dim0) uint64
    (server_host.build_db_tensor) -> the dense int8 limb DB on ``device``.
    The limbs are split on the host, so the device holds only the int8
    index."""
    return db_from_host_tensor(params, db_host).to(device)


def index_hbm_bytes(params: Params) -> int:
    """Device bytes of the dense encrypted index: crt * NUM_LIMBS int8
    entries per coefficient of every item (the JAX engine's count)."""
    return int(np.prod(sj.db_shape(params), dtype=np.int64))


def serving_working_set_bytes(params: Params, nq: int = 16) -> int:
    """Estimated device bytes next to the index while an nq-query batch is
    in flight. The scan's query and output columns; every query's folding
    keys and their negations; the batched expansion, which runs all nq
    queries at once: its two round buffers (a round's input and output, up
    to 2^g int32 cts a query; the regev_to_gsw kernel reads the last
    round's GSW leaves in place and writes only the folding keys and their
    negations, so it adds nothing); and the batch's fold input, which is
    made for all nq queries at once: the scan output regrouped per query,
    its inverse NTT (int32 residues, three live copies with the
    regrouping), and the CRT-composed int64 values with the compose's
    temporaries (five live arrays of that size, the first round's output
    included). The fused fold and pack kernels keep their digit
    polynomials in shared memory, so the rounds add nothing."""
    crt, z = params.crt_count, params.poly_len
    dim0 = 1 << params.db_dim_1
    num_per = 1 << params.db_dim_2
    m = params.instances * params.n * params.n * num_per
    scan = crt * z * (m + dim0) * 2 * nq * 4
    keys = nq * params.db_dim_2 * 2 * 2 * params.t_gsw * crt * z * 4 * 2
    expand = 2 * nq * (1 << params.g()) * 2 * crt * z * 4
    fold = nq * m * 2 * z * (3 * crt * 4 + 5 * 8)
    return scan + keys + expand + fold


def pp_to_device(params: Params, pp: PublicParameters, device) -> dict:
    """Public-parameter matrices as int32 device tensors, each paired with
    its Shoup companions (session-fixed key material)."""
    def keyed(m: np.ndarray):
        return (u32_bits(m, device),
                u32_bits(shoup_companion_arr(params, m), device))

    out = {"v_packing": [keyed(m) for m in pp.v_packing]}
    if params.expand_queries:
        out["v_exp_left"] = [keyed(m) for m in pp.v_expansion_left]
        right = pp.v_expansion_right or pp.v_expansion_left
        out["v_exp_right"] = [keyed(m) for m in right]
        out["v_conversion"] = keyed(pp.v_conversion[0])
    return out


class SpiralServerTorch:
    """Device-resident Spiral server for one parameter set on one device,
    or, with ``mesh`` (ops/shard.Mesh, axes dp and db), over the mesh's
    devices: the dense index is cut into shards (dim0 over db, trials over
    dp) and ``device`` is the mesh's home device (server_jax.py:202-210)."""

    def __init__(self, params: Params, device="cuda", mesh: Mesh | None = None):
        self.params = params
        self.mesh = check_mesh(mesh)
        self._sharded = None if mesh is None else ShardedSpiralScan(params, mesh)
        self.device = mesh.home if mesh is not None else torch.device(device)
        # a direct-upload engine expands nothing (server_jax.py:170)
        self.plan = self._schedule = None
        if params.expand_queries:
            self.plan = sj.ExpansionPlan(params, self.device)
            self._schedule = sj.dense_schedule(
                params, params.t_gsw * params.db_dim_2, self.device)
        g = hpoly.to_ntt(params, hpoly.build_gadget(params, 2, 2 * params.t_gsw))
        self.gadget_ntt = u32_bits(g, self.device)
        # the GSW leaves' positions among a dense expansion's leaves
        self._dense_gsw_pos = torch.arange(
            1, 2 * params.t_gsw * params.db_dim_2, 2, dtype=torch.int32,
            device=self.device)
        self.encode_plan = ResponseEncodePlan(params, self.device)
        self.db: torch.Tensor | sj.CompactDb | None = None
        # the rows the installed index holds, as its owner counts them on
        # the host: set_db counts every row of a dense index and none of a
        # compact one; the bucket sets it at each flush (the rows written)
        self.index_rows = 0
        self._splan: sj.SparseExpansionPlan | None = None
        # resolved stage events, recorded again by later dispatches
        self._free_events: list = []

    # -- state --

    def set_db(self, db) -> None:
        """Install a dense DB tensor (spiral.db_shape, int8) or a
        spiral.CompactDb; with a mesh, a dense tensor (cut over the mesh) or
        a shard.ShardedDb of the mesh (sharded serving is dense)."""
        params = self.params
        if self._sharded is not None:
            if isinstance(db, ShardedDb):
                if db.mesh is not self.mesh or db.shape != sj.db_shape(params):
                    raise ValueError("a ShardedDb of another mesh or shape")
                self.db = db
            elif isinstance(db, sj.CompactDb):
                raise ValueError("sharded serving runs the dense index only")
            else:
                self.db = self._sharded.shard_db(db)
        elif isinstance(db, sj.CompactDb):
            cap = db.cap_bin
            if (tuple(db.planes.shape) != sj.compact_shape(params, cap)
                    or db.planes.dtype != torch.int8
                    or db.idx_j.dtype != torch.int32):
                raise ValueError(f"bad compact DB {db.planes.dtype} "
                                 f"{tuple(db.planes.shape)}")
            self.db = sj.CompactDb(db.planes.to(self.device),
                                   db.idx_j.to(self.device))
        else:
            if tuple(db.shape) != sj.db_shape(params) or db.dtype != torch.int8:
                raise ValueError(f"bad DB tensor {db.dtype} {tuple(db.shape)}")
            self.db = db.to(self.device)
        self.index_rows = (0 if isinstance(db, sj.CompactDb)
                           else params.num_items())

    def set_db_host_tensor(self, db_host: np.ndarray) -> None:
        if self._sharded is not None:
            # cut on the host: each device receives only its shard
            self.set_db(db_from_host_tensor(self.params, db_host))
            return
        self.set_db(db_tensor_to_device(self.params, db_host, self.device))

    def set_populated_dim0(self, populated) -> None:
        """Enable compacted sparse query expansion: only the ciphertexts
        whose first-dim indices are in ``populated`` are expanded (see
        spiral.SparseExpansionPlan). None, an empty set or the full set
        restore dense expansion (server_jax.py:236-255). A direct-upload
        engine expands nothing and keeps no plan."""
        params = self.params
        if populated is None or not params.expand_queries:
            self._splan = None
            return
        pop = sorted({int(i) for i in populated})
        if not pop or len(pop) == 1 << params.db_dim_1:
            self._splan = None
            return
        self._splan = sj.SparseExpansionPlan(
            params, pop, params.t_gsw * params.db_dim_2, self.device)

    def _pp_dev(self, pp) -> dict:
        return pp if isinstance(pp, dict) else pp_to_device(self.params, pp,
                                                            self.device)

    # -- stages --

    def expand_queries(self, pp_devs: list, queries: list,
                       columns: int | None = None):
        """Expand a batch of queries, each with its own keys: one launch of
        kernel E a round for the whole batch (dense, or the sparse schedule
        once a populated set is installed) and one of the regev_to_gsw
        kernel. Returns the scan columns (crt, z, dim0, 2 * columns),
        column 2*i + r row r of query i, the columns of queries past the
        batch (up to ``columns``, default the batch) copies of query 0's;
        the folding keys (NQ, db_dim_2, 2, 2*t_gsw, crt, z); and their
        negations (the same shape), which the fold takes beside them."""
        params = self.params
        nq = len(queries)
        columns = columns or nq
        crt, n = params.crt_count, params.poly_len
        ct = to_device(torch.from_numpy(np.stack([q.ct for q in queries])
                                        .astype(np.int64)), self.device)
        ct0 = sj.to_ntt(params, ct)                     # (NQ, 2, 1, crt, n)
        keys = sj.ExpansionKeys(params, pp_devs)
        dim0 = 1 << params.db_dim_1
        splan = self._splan
        leaves = sj.expand_batch(params, self.plan, self._schedule if splan
                                 is None else splan.schedule, ct0, keys)
        if splan is None:
            stride = 2 if params.db_dim_2 > 0 else 1
            v_reg = leaves[:, 0::stride][:, :dim0]
            cols = torch.empty((crt, n, dim0, columns, 2), dtype=torch.int32,
                               device=self.device)
            cols[:, :, :, :nq] = v_reg[:, :, :, 0].permute(3, 4, 1, 0, 2)
        else:
            # the Regev leaves land at their dim0 columns of a zero query;
            # the unpopulated columns meet only zero DB rows
            # (server_jax.py:279-302)
            v_reg = leaves.index_select(1, splan.even_leaf_pos)
            cols = torch.zeros((crt, n, dim0, columns, 2), dtype=torch.int32,
                               device=self.device)
            cols[:, :, splan.even_dim0_idx, :nq] = v_reg[:, :, :, 0].permute(
                3, 4, 1, 0, 2)
        if columns > nq:
            cols[:, :, :, nq:] = cols[:, :, :, :1]
        if params.db_dim_2 > 0:
            # the GSW leaves read in place, each query's key through the
            # batch's pointer table
            pos = self._dense_gsw_pos if splan is None else splan.odd_leaf_pos
            v_folding, v_neg = sj.regev_to_gsw_neg(
                params, leaves, pos, keys, self.gadget_ntt)
        else:
            v_folding = torch.zeros((nq, 0, 2, 2 * params.t_gsw, crt, n),
                                    dtype=torch.int32, device=self.device)
            v_neg = v_folding
        return cols.reshape(crt, n, dim0, 2 * columns), v_folding, v_neg

    def direct_columns(self, queries: list,
                       columns: int | None = None) -> torch.Tensor:
        """Direct-upload queries' reoriented buffers (each v_buf: [z][j][r]
        u64 words, CRT channel 0 in the low 32 bits, 1 in the high) -> the
        scan columns (crt, z, dim0, 2 * columns) int32, laid out as
        expand_queries lays them out (server_jax.py:425-431). Each buffer is
        uploaded as it is, as int64, and split on the device."""
        params = self.params
        nq = len(queries)
        columns = columns or nq
        n, dim0 = params.poly_len, 1 << params.db_dim_1
        if params.crt_count != 2:
            raise ValueError("direct-upload buffers pack two CRT channels")
        buf = torch.empty((nq, n, dim0, 2), dtype=torch.int64,
                          device=self.device)
        for i, q in enumerate(queries):
            words = np.ascontiguousarray(q.v_buf, dtype=np.uint64)
            buf[i].copy_(torch.from_numpy(words.view(np.int64)
                                          .reshape(n, dim0, 2)))
        v = buf.permute(1, 2, 0, 3)                    # (z, dim0, NQ, 2)
        cols = torch.empty((2, n, dim0, columns, 2), dtype=torch.int32,
                           device=self.device)
        cols[0, :, :, :nq] = v & 0xFFFFFFFF
        cols[1, :, :, :nq] = v >> 32
        if columns > nq:
            cols[:, :, :, nq:] = cols[:, :, :, :1]
        return cols.reshape(2, n, dim0, 2 * columns)

    def direct_keys(self, queries: list):
        """Direct-upload queries' raw GSW cts (each v_ct: db_dim_2 x (2,
        2*t_gsw, z) u64) -> the folding keys (NQ, db_dim_2, 2, 2*t_gsw,
        crt, z), one launch of kernel A for the batch (server_jax.py:432-
        435), and their negations (gadget - v) mod q_c."""
        params = self.params
        nq, crt, n = len(queries), params.crt_count, params.poly_len
        if params.db_dim_2 == 0:
            v_folding = torch.zeros((nq, 0, 2, 2 * params.t_gsw, crt, n),
                                    dtype=torch.int32, device=self.device)
            return v_folding, v_folding
        raw = np.stack([np.stack(q.v_ct) for q in queries])
        v_ct = torch.from_numpy(raw.astype(np.int64)).to(self.device)
        v_folding = sj.to_ntt(params, v_ct)
        return v_folding, sj.negate_folding_keys(params, v_folding,
                                                 self.gadget_ntt)

    def query_to_device(self, pp_devs: list, queries: list,
                        columns: int | None = None):
        """A batch of either kind of query -> (scan columns (crt, z, dim0,
        2 * columns), folding keys, their negations), as expand_queries
        returns them: the expansion, or the direct-upload queries' own
        columns and keys (server_jax.py:420-436)."""
        if self.params.expand_queries:
            return self.expand_queries(pp_devs, queries, columns)
        return (self.direct_columns(queries, columns),
                *self.direct_keys(queries))

    def expand_query(self, pp_dev: dict, query: Query):
        """Query ct -> (scan columns (crt, z, dim0, 2), folding keys
        (db_dim_2, 2, 2*t_gsw, crt, z)): expand_queries of one query."""
        q_arr, v_folding, _ = self.expand_queries([pp_dev], [query])
        return q_arr, v_folding[0]

    def direct_query(self, query: Query):
        """expand_query's direct-upload counterpart: one query's uploaded
        scan columns (crt, z, dim0, 2) and folding keys (db_dim_2, 2,
        2*t_gsw, crt, z)."""
        v_folding, _ = self.direct_keys([query])
        return self.direct_columns([query]), v_folding[0]

    def _pack_encode(self, folded: torch.Tensor, v_packings: list):
        """Folded cts (NQ, inst, trials, 2, 1, z) and each query's packing
        keys -> the wire responses (NQ, words) int32 on the device: one
        launch of kernel G (pack, from_ntt and encode) for the batch."""
        return sj.pack_encode(self.params, folded, v_packings,
                              self.encode_plan)

    def _dispatch(self, pps: list, queries: list,
                  marks: list | None = None) -> torch.Tensor:
        """Enqueue a batch: one batched expansion, ONE scan with R = 2*NQ
        columns (column 2*i + r is row r of query i), one fold and one pack
        + encode for the whole batch. NQ is padded to a power of
        two with copies of query 0's columns (server_jax.py:644-648), so R
        always splits into the scan kernel's column blocks; the fillers'
        columns are dropped after the scan. With a mesh the scan and fold
        run per shard (ShardedSpiralScan.scan_fold, server_jax.py:710-727).
        A direct-upload batch takes its columns and keys from the queries
        (query_to_device) and runs the same scan, fold and pack. While the
        CLIENT_TEST hook is set, a batch of one waits for its fold and
        checks query 0's instance-0 / trial-0 folded ct before G is
        launched (server_jax.py:552-556); larger batches are not checked
        (server_jax.py:654). With ``marks`` (a list, on a card) a timing
        event is recorded at each stage boundary (see _marker).
        Returns (NQ, words) int32."""
        n_real = len(queries)
        pad_n = 1 << (n_real - 1).bit_length()
        mark = self._marker(marks)
        mark(None)
        q_all, v_foldings, v_neg = self.query_to_device(pps, queries, pad_n)
        mark("device.expand")
        if self._sharded is not None:
            folded = self._sharded.scan_fold(self.db, q_all, n_real,
                                             v_foldings, v_neg)
            mark("device.scan_fold")
        else:
            inter = sj.firstdim_multiply(self.params, self.db, q_all)
            mark("device.scan")
            inter = inter.reshape(inter.shape[:-1] + (pad_n, 2))[..., :n_real, :]
            folded = fold_columns(self.params, inter, v_foldings, v_neg)
            mark("device.fold")
        if n_real == 1 and client_test_active():
            ct = folded[0, 0, 0].cpu().numpy().astype(np.uint64)
            check_folded_ct(self.params, ct)
        words = self._pack_encode(folded, [pp["v_packing"] for pp in pps])
        mark("device.pack")
        return words

    def _marker(self, marks: list | None):
        """The function that marks a stage boundary of one dispatch: it
        records a timing event, taken from the engine's free events or
        made, on the dispatch's stream (looked up once: a lookup costs
        more host time than a record) and appends (the stage it closes, or
        None for the first, event) to ``marks``; without ``marks`` it does
        nothing."""
        if marks is None:
            return _no_mark
        stream = torch.cuda.current_stream(self.device)
        free = self._free_events

        def mark(stage: str | None) -> None:
            try:
                ev = free.pop()
            except IndexError:
                ev = torch.cuda.Event(enable_timing=True)
            ev.record(stream)
            marks.append((stage, ev))

        return mark

    # -- host orchestration --

    def _require_db(self) -> None:
        if self.db is None:
            raise RuntimeError("no DB installed")

    def process_query(self, pp, query: Query) -> bytes:
        return self.dispatch_queries_batched([(pp, query)])()[0]

    def dispatch_queries_batched(self, requests: list):
        """Two-phase batched serving: enqueue the whole batch on the
        device's current stream (see _dispatch) and return a zero-arg fetch
        closure that copies the response words to the host (waiting for the
        queued work) and returns the response bytes.

        On a card the dispatch makes no synchronizing call (the uploads go
        through pinned buffers, the moduli are made once), so it returns
        while the batch runs and the next batch's dispatch can overlap it;
        only a batch of one under the CLIENT_TEST hook waits for its fold.

        The per-query key material is not stacked: kernel F takes the
        batch's folding keys, which each expansion makes anew, as one
        stacked tensor, and kernels E, regev_to_gsw and G read each
        client's keys through tables of pointers, so there is no
        stacked-key cache to budget (the JAX engine's LRU,
        server_jax.py:183-195). The fetch holds those key tensors until the
        batch has run, whatever /clear, an eviction or a new setup does to
        the session dicts meanwhile.

        Traced (telemetry): the enqueue is the span ``engine.dispatch``
        (count: the batch's queries; its trace id is the dispatch's), with
        a zero-length record ``engine.index`` inside it whose count is the
        rows the scanned index holds (``index_rows``, kept on the host), the
        fetch's copy ``engine.fetch`` and the bytes ``engine.to_bytes``. On
        a card the stage events are resolved after the copy has returned,
        when they are complete, so resolving them waits for nothing: one
        ``device.*`` record a stage, whose duration is the stage's stream
        time (its placement is made up: laid back to back with the others
        so that the last ends when they are resolved). The resolved events
        go back to the engine's free events."""
        self._require_db()
        n_real = len(requests)
        marks = [] if self.device.type == "cuda" else None
        with GLOBAL_TIMERS.span("engine.dispatch", n_real) as span:
            t = time.monotonic_ns()
            GLOBAL_TIMERS.add("engine.index", t, t, span.span, span.trace,
                              self.index_rows)
            pps = [self._pp_dev(pp) for pp, _ in requests]
            words = self._dispatch(pps, [q for _, q in requests], marks)
            held = _tensors(pps)

        def fetch():
            with GLOBAL_TIMERS.span("engine.fetch", n_real, span.trace):
                host = words.cpu().numpy()    # waits for the queued work
            held.clear()
            if marks:
                _record_stages(marks, span)
                self._free_events.extend(ev for _, ev in marks)
            with GLOBAL_TIMERS.span("engine.to_bytes", n_real, span.trace):
                return [self.encode_plan.to_bytes(host[i])
                        for i in range(n_real)]

        return fetch


def _no_mark(stage: str | None) -> None:
    pass


def _record_stages(marks: list, span) -> None:
    """The stage events of a finished dispatch -> its device.* records:
    each stage's stream time, the records laid back to back ending now."""
    stages = [(stage, round(prev.elapsed_time(ev) * 1e6))
              for (_, prev), (stage, ev) in zip(marks, marks[1:])]
    t = time.monotonic_ns() - sum(ns for _, ns in stages)
    for stage, ns in stages:
        GLOBAL_TIMERS.add(stage, t, t + ns, span.span, span.trace,
                          span.count)
        t += ns


def _tensors(obj) -> list:
    """Every tensor in nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = obj.values()
    elif not isinstance(obj, (list, tuple)):
        return []
    return [t for x in obj for t in _tensors(x)]
