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
from .modops import shoup_companion_arr, u32_bits
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
        self._splan: sj.SparseExpansionPlan | None = None

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
            return
        if isinstance(db, sj.CompactDb):
            cap = db.cap_bin
            if (tuple(db.planes.shape) != sj.compact_shape(params, cap)
                    or db.planes.dtype != torch.int8
                    or db.idx_j.dtype != torch.int32):
                raise ValueError(f"bad compact DB {db.planes.dtype} "
                                 f"{tuple(db.planes.shape)}")
            self.db = sj.CompactDb(db.planes.to(self.device),
                                   db.idx_j.to(self.device))
            return
        if tuple(db.shape) != sj.db_shape(params) or db.dtype != torch.int8:
            raise ValueError(f"bad DB tensor {db.dtype} {tuple(db.shape)}")
        self.db = db.to(self.device)

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
        ct = torch.from_numpy(np.stack([q.ct for q in queries])
                              .astype(np.int64)).to(self.device)
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

    def _dispatch(self, pps: list, queries: list) -> torch.Tensor:
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
        (server_jax.py:654). Returns (NQ, words) int32."""
        n_real = len(queries)
        pad_n = 1 << (n_real - 1).bit_length()
        q_all, v_foldings, v_neg = self.query_to_device(pps, queries, pad_n)
        if self._sharded is not None:
            folded = self._sharded.scan_fold(self.db, q_all, n_real,
                                             v_foldings, v_neg)
        else:
            inter = sj.firstdim_multiply(self.params, self.db, q_all)
            inter = inter.reshape(inter.shape[:-1] + (pad_n, 2))[..., :n_real, :]
            folded = fold_columns(self.params, inter, v_foldings, v_neg)
        if n_real == 1 and client_test_active():
            ct = folded[0, 0, 0].cpu().numpy().astype(np.uint64)
            check_folded_ct(self.params, ct)
        return self._pack_encode(folded, [pp["v_packing"] for pp in pps])

    # -- host orchestration --

    def _require_db(self) -> None:
        if self.db is None:
            raise RuntimeError("no DB installed")

    def process_query(self, pp, query: Query) -> bytes:
        self._require_db()
        with GLOBAL_TIMERS.stage("query_fused"):
            words = self._dispatch([self._pp_dev(pp)], [query])
            return self.encode_plan.to_bytes(words[0])

    def dispatch_queries_batched(self, requests: list):
        """Two-phase batched serving: enqueue the whole batch on the
        device's current stream (see _dispatch) and return a zero-arg fetch
        closure that copies the response words to the host (waiting for the
        queued work) and returns the response bytes.

        The per-query key material is not stacked: kernel F takes the
        batch's folding keys, which each expansion makes anew, as one
        stacked tensor, and kernel G reads each client's packing keys
        through a table of pointers, so there is no stacked-key cache to
        budget (the JAX engine's LRU, server_jax.py:183-195)."""
        self._require_db()
        n_real = len(requests)
        words = self._dispatch([self._pp_dev(pp) for pp, _ in requests],
                               [q for _, q in requests])

        def fetch():
            host = words.cpu().numpy()        # waits for the queued work
            return [self.encode_plan.to_bytes(host[i]) for i in range(n_real)]

        return fetch
