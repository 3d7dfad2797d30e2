#!/usr/bin/env python3
"""Drive the sdk_tpu_torch main paths once on one CUDA card: the Spiral
private read over the bucket lifecycle, the bucket's HTTP service, the
direct-upload read, and the DoublePIR checklist.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from sdk_tpu_torch/csrc with nvcc, one
   process per source, all at once.
3. kernels: A, A', B, D, the regev_to_gsw kernel (B redesigned: a batch's
   folding keys and their negations in one launch) and the fused F (fold
   round), G (pack), H (ingest) against their plain PyTorch versions on
   the card at the main path's shapes (1 GiB bucket), exactly (integer
   results, tolerance 0), timed with CUDA events beside their bounds: the
   regev_to_gsw kernel at NQ = 1 and 16 on dense and S1 sparse leaves,
   beside the chain it replaced (A', B, A and the torch glue, then
   get_v_folding_neg); B (off the read path) at its former shapes; A and
   A' at 8,192 polynomials and
   at 24 and 6,144 (the expansion's rounds 1 and 9 before kernel E) and
   the read path's 65,536 (the 16-batch's fold input), each checked whole; F at every
   round of a fold at NQ = 1 and 16, every query checked, and the whole
   fold; G in its three output modes (NTT, raw, and the response words of
   pack + from_ntt + encode, the read path's) at NQ = 1 (a cluster of n
   blocks a column) and 16 (one block), every query checked, version 1
   and version 0, each timed. D (off the read path: G encodes) and B
   (off it since the regev_to_gsw kernel) are still checked and timed.
4. small configs: whole responses of the port on the card byte-identical to
   the port on the CPU (the plain versions), decoded by the port's Client.
5. lifecycle: a fresh 1 GiB bucket (2^15 items x 32 KiB) through its three
   states: S1, about 100 keys written (compact index, sparse expansion);
   S2, about 3,500 items (compact, dense expansion); S3, past 4,096 items
   (migrated to the dense index by kernel H'). In each state single reads
   through private_read and one 16-query batch (4 sessions x 4 queries)
   decode to the written values. Kernel I (compact scan, in S1 and S2), H'
   (dense migration, on the S2 index before it migrates) and C (dense
   scan on the int8 tensor cores, in S3) are held against their plain
   versions on the state's index; E (the batched expansion round) on every
   round of a whole dense expansion and of the S1 sparse one, at NQ = 1
   and at NQ = 16 with 16 key sets, each round timed beside its bound; E'
   (the expansion's elementwise body, off the read path since E) at its
   former shapes; the scans are timed beside torch._int_mm over the same
   bytes at 8 and 32 columns.
6. full size: a second bucket filled with all 2^15 seeded rows (its first
   flush stays compact, its second migrates; an 8.59 GB dense index), three
   keys written, read through private_read and one 16-query batch; C's
   row: R = 2 and 32 on a z-slice and the whole index, share of bound,
   its tilings and the build's registers and spills (-Xptxas -v); R = 128
   in C's resident form (row scan_resident), and a 48-query dispatch
   decoded, whose scan is one resident launch; the
   expansion's hand launches for a read and for a 16-batch (equal,
   EXPANSION_LAUNCHES: one A, one E a round and one regev_to_gsw for the
   whole batch); the stage split of a single read and a 16-query batch.
6b. sharded: the same rows in a bucket whose dense index is cut over a
   (dp=2, db=4) mesh of eight LOGICAL shards of the one card (dim0 128 and
   8 instance-trials a shard); the full bucket's probe blobs, a single read
   and a 16-query batch, answered with the same bytes and decoded, then
   timed in alternation with the unsharded bucket (kept from 6); kernel M
   (the exact mod-q sum of the shards' partials) against its plain version
   at D = 2, 4, 8 in both forms; the two selfchecks; a DCN front end over
   two port backends at V1_SMALL against one port server; the row-sharded
   checklist at a small byte-element config against the unsharded one.
7. service: the 1 GiB bucket behind its HTTP service on localhost, driven
   through sdk_tpu_torch.clients only: setup (JSON and presigned upload),
   /write of a few hundred keys, private reads, 16 readers at once through
   the read coalescer, /update-row past the dense migration, /bloom,
   /list-keys, /meta, /modify, checkpoints of the compact and the dense
   index restored into new buckets that answer with the same bytes, /clear,
   /destroy. On the dense index (8.59 GB), the dispatch check: a warm
   16-batch's dispatch_queries_batched under
   torch.cuda.set_sync_debug_mode("error") (no synchronizing call), its
   host time beside the batch's device time, a CUDA event recorded right
   after the dispatch not yet complete, then the fetch, the warm batch's
   bytes, every response decoded. The dense checkpoint is kept for 7a.
7a. load: tools/load_test_torch.py spawns the port's server on the card
   (python -m sdk_tpu_torch.server.http, a process of its own) from that
   checkpoint, warmed, with the service's 25 ms coalescing window; then
   closed loops of 1, 4 and 16 clients and of 16 with the writer (flushes,
   kernel H, racing the reads), LOAD_DURATION_S each, each the tool in a
   process of its own; every read decode-verified; each run's summary
   (reads/s, latency p50/p90/p99, coalesced batches, the clients' own
   time) on a line with the card. Fails on an error, a run without reads,
   or a 16-client run that never coalesced.
7b. direct upload: the small direct-upload config (each request carries
   its public params, scan columns and GSW keys: no expansion) on the card
   against the CPU plain versions byte for byte; then the full 1 GiB bucket
   with "direct_upload": 1 (filled like 6, an 8.59 GB dense index, no
   sparse expansion plan): 4 distinct seeded requests read alone and in two
   16-query batches through dispatch_read_blobs, every response decoded;
   DIRECT_READ_LAUNCHES hand launches for a read and for a 16-batch (1 A,
   the scan, 1 A', 6 F, 1 G); the stage split (request parse, key prep,
   column upload and unpack, A on the keys, scan, fold, G); one read and 4
   readers at once over HTTP (a wider coalescing window:
   DIRECT_BATCH_WINDOW_MS).
7c. client_test: the CLIENT_TEST hook on the card at the fast params and
   the small direct config: the right target answers the bytes of a read
   without the hook; a wrong one raises ClientTestFailure with no G launch.
8. DoublePIR kernels: K (int8 DB products: one plane, the lo/hi pair, with
   the colsum row, with the row-batch select) and L (wrapping u32 products,
   plain and packed, and its answer form: msg0 = a_1t @ A2 and h_2 = a_1t
   @ q2 in one launch, at nq = 8 and 1, timed beside the two packed
   launches it replaced) against their plain versions at the checklist
   path's shapes, on row slices that int64 can hold (the answer's a_2 in
   K's narrow form at nq = 8 and 1). K's tiled form (the hint
   setup's, one int8 tensor-core product a byte plane of the u32 operand)
   is checked on a launch whose last row band is ragged, as the whole
   DB's is, and timed on a 4,224-row sample of H1 beside its int8 and its
   former int32 bound, torch._int_mm over the same rows x 4n int8 columns
   (the faster of its two layouts) and its registers and spills; the
   schedule's HBM bytes by an analytic model go to the log only.
9. DoublePIR small configs: two byte-element configs and one general
   (p=991) config; hint and answers on the card equal the port's numpy
   scheme word for word, and every planted bit is recovered.
10. checklist at the production config (1024,6.4,92681,92683,32,464: 2^36
   bloom bits, an 8.59 GB one-byte-per-element DB on the card): keys in,
   hint setup with the real AES-derived A1/A2 (5 K launches: H1 over the
   whole DB and one H2 a digit plane; its wall as a user meets it, then
   the same rebuild again split into the DB upload, the derive and upload
   of A1 / A2, H1, the digit-plane glue, the H2 launches and _install_a2,
   with H1's first and last row bands held against the plain version and
   the same hint), 8-query membership batches through the
   port's client (2 K + 1 L launches an answer): members found, a
   non-member's bits decode to 0, a tampered query does not decode; K's
   narrow form held against its plain version on the bucket's own a_2
   operands (every hint row, nq = 8 and 1), timed beside its bound,
   torch._int_mm over both planes stacked x 32 int8 columns, its blocks
   an SM and ptxas report; the whole DB's level 1 beside torch._int_mm;
   K tiled's whole H1 and one H2 pair launch beside torch._int_mm at their
   shapes (yardsticks beside the kernel's times from
   tools/scan_bench_gpu.py --kernel dot).
11. device times: A, A' and F at the shapes of 3, E on every round of
   a dense expansion at NQ = 1 and 16, the regev_to_gsw kernel and the
   chain it replaced at NQ = 1 and 16, K's tiled form on the H1 sample
   and its narrow form at a_2 (nq = 8 and 1), L's answer form (and the two
   launches before it) of 8, M at the sharded read's and 16-batch's
   partials, and G in
   each mode at NQ = 1 and 16
   beside its latency bound (the dependent transforms of pack's dataflow
   times A's and A''s device time on one polynomial pair), from torch.profiler, last, because
   a profiler session slows the launches that follow it.
11b. traces: tools/profile_trace_torch.py --target batch16, then --target
   direct, each in a process of its own (a torch.profiler trace of the
   1 GiB bucket's 16-batch: the device's idle share, the host gaps between
   the hand launches; traces under build/traces/); their JSON lines.
11c. multiproc: tools/multiproc_worker_torch.py --case bucket, each rank a
   process of its own on cuda:0: kernel C's R = 32 partials of the 1 GiB
   bucket's index cut into W x 2 dim0 shards (2 a rank), summed across the
   ranks by psum_mod_group (one all_gather of the int32 partials, then
   kernel M on every rank), equal to C over the whole index and to
   psum_mod_plain, M launched once a rank: two gloo ranks (the all_gather
   through the host; two processes share the one card), then one NCCL
   rank (W = 1; NCCL takes one rank a card); each rank also times the
   library's torch.stack(parts).sum(0) % q over the gathered parts; their
   JSON lines.
12. report: launches of every kernel on the main paths (5, 6, 6b, 7, 7b and
   10, each must be > 0 but E''s, D's and B's, which no path launches
   since E, G's out_words mode and the regev_to_gsw kernel; a service
   read and a 16-batch make READ_LAUNCHES each),
   memory, wall times, and the kernel table as one
   JSON line; then the card, and as the last line, the device (count 1:
   the mesh of 6b is logical shards of that one card).

Launches are counted only while a phase drives the main path: the counts
are set to 0 just before its reads and read just after, so the launches of
a kernel-vs-plain comparison never count.
"""

from __future__ import annotations

import base64
import bz2
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 20261016
V1_SMALL = ('{"n": 2, "nu_1": 5, "nu_2": 2, "p": 256, "q2_bits": 22,'
            ' "t_gsw": 7, "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5,'
            ' "instances": 2, "db_item_size": 16384, "version": 1}')
KEYS = ("alpha", "bravo", "charlie")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT8_OPS_PER_S = 1979e12        # H100 SXM int8 tensor-core peak (dense)
INT32_OPS_PER_S = 67e12         # H100 SXM CUDA-core 32-bit peak (fp32 rate)
CHECKLIST = "1024,6.4,92681,92683,32,464"   # the production checklist config
P16 = ('{"n": 2, "nu_1": 2, "nu_2": 2, "p": 16, "q2_bits": 20, "t_gsw": 8,'
       ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
       ' "version": 0}')
# p = 256 with 251-byte chunks: H reads such chunks a byte at a time
P256_ODD = ('{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,'
            ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
            ' "db_item_size": 1001, "version": 0}')
BATCH_WINDOW_MS = 25.0          # the service's read-coalescing window
# the direct-upload service's window: each request carries ~10 MB (13 MB of
# JSON), which the server's handler threads decode one at a time under the
# GIL while the leader parses its batch, so 4 readers arrive ~0.1-1 s apart
DIRECT_BATCH_WINDOW_MS = 2000.0
# integer operations of one Harvey butterfly, as the A / A' rows count them
BUTTERFLY_OPS = 6
# kernels held against their plain versions that no main path launches:
# E' (expand_round.cu), which kernel E replaced on the expansion path, D
# (encode.cu), whose work kernel G does in its out_words mode, and B
# (matmul_mod.cu), whose work on the read path the regev_to_gsw kernel does
OFF_PATH = ("expand_round", "encode", "matmul_mod")
# hand launches of the expansion of a read of the 1 GiB bucket, the same for
# a 16-batch: 1 A for the query cts, 10 E, 1 regev_to_gsw (the folding keys
# and their negations)
EXPANSION_LAUNCHES = 12
# hand launches of a read, the same for a 16-batch: the expansion's 12, the
# scan, the fold input's A', 6 F, and 1 G for pack + encode
READ_LAUNCHES = 21
# hand launches of a direct-upload read, the same for a 16-batch: 1 A for the
# batch's GSW keys, the scan, the fold input's A', 6 F and 1 G
DIRECT_READ_LAUNCHES = 10
# the direct-upload config of tests/test_kv_service.py:137
DIRECT_SMALL = ('{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
                ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
                ' "t_exp_right": 8}')


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over iters launches, after a warm
    call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str, iters: int):
    """Mean device milliseconds of the kernels whose name holds ``name``
    over iters calls of fn, from torch.profiler (CUDA events over back-to-
    back calls of a short kernel carry the wrapper's host time); None when
    three traces in a row hold no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a trace now and then comes back without them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0) or
                 getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if name in e.key)
        if us:
            return us / iters / 1e3
    return None


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max())


def max_abs_err_int8(got: torch.Tensor, want: torch.Tensor) -> int:
    """max_abs_err of two int8 indexes too large to widen at once, one
    (channel, 256-row z block) slice at a time."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = 0
    for c in range(got.shape[0]):
        for z0 in range(0, got.shape[1], 256):
            d = (got[c, z0:z0 + 256].to(torch.int16)
                 - want[c, z0:z0 + 256].to(torch.int16))
            err = max(err, int(d.abs().max()))
    return err


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the peak rate of their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def int_mm_ms(planes: torch.Tensor, cols: int = 8) -> float:
    """torch._int_mm over the same int8 bytes as a scan reads, against
    ``cols`` int8 columns: the nearest library yardstick. It computes no
    mod-q recombination and the port never calls it."""
    a = planes.reshape(-1, 256)
    b = torch.ones((256, cols), dtype=torch.int8, device=planes.device)
    try:
        return cuda_ms(lambda: torch._int_mm(a, b), 10)
    except RuntimeError as e:          # a yardstick only: record its absence
        log(f"[library] torch._int_mm refused {tuple(a.shape)} x "
            f"(256, {cols}): {e}")
        return None
    finally:
        torch.cuda.empty_cache()


def tiled_hbm_bytes(M: int, K: int, N: int, bm: int, bn: int, sms: int,
                    pair: bool = False) -> int:
    """HBM bytes of kernel K's tiled schedule by an analytic model, not a
    reading (block tiles bm x bn, blocks in order n tile fastest): each
    wave of ``sms`` consecutive blocks (one an SM) reads every row band and
    column tile it shares once through the L2: the wave's distinct bands of
    a (and a_hi) and distinct column tiles of b, plus the output once."""
    mt, nt = -(-M // bm), -(-N // bn)
    total = 0
    for w0 in range(0, mt * nt, sms):
        bands, cols = set(), set()
        for bid in range(w0, min(mt * nt, w0 + sms)):
            bands.add(bid // nt)
            cols.add(bid % nt)
        total += sum(min(bm, M - b * bm) for b in bands) * K * (1 + pair)
        total += sum(min(bn, N - c * bn) for c in cols) * K * 4
    return total + M * N * 4


def tiled_ptxas() -> dict:
    """Registers and spill bytes of kernel K's tiled forms (one plane,
    pair), from the build's -Xptxas -v report."""
    from sdk_tpu_torch import _build

    out = {}
    for name, use in _build.ptxas_usage("dp_dot_i8").items():
        m = re.search(r"dot_i8_tiled_kernelILb(\d)E", name)
        if m:
            out[f"pair{m.group(1)}"] = use
    return out


@contextlib.contextmanager
def setup_split(st, check_h1=None):
    """Yields a dict that gets the wall seconds of a checklist bucket's
    hint rebuild made inside the block, by part: the DB upload (the
    engine's construction), the AES derive and upload of A1 and A2, H1's
    one whole-DB launch of kernel K, the four H2 launches, _install_a2,
    the digit-plane glue (the rest of ``setup``), and H1's and the H2
    launches' device milliseconds (CUDA events around each call). Every
    part starts and ends with a synchronize, so a wall taken around the
    block is not the rebuild's own. ``check_h1(h1, a, b, c=...)``, if
    given, gets H1 and its operands after H1 is timed (its seconds in
    ``h1_check_s``, outside every part). The wrappers launch nothing."""
    cls = st.ChecklistServerTorch
    patched = {cls: ["__init__", "_stream_derived_to_device", "setup",
                     "_install_a2"],
               st: ["dot_i8_u32", "dot_i8pair_u32"]}
    keys = {"__init__": "db_upload_s", "_stream_derived_to_device":
            "derive_upload_s", "setup": "setup_s", "_install_a2":
            "install_a2_s", "dot_i8_u32": "h1_s", "dot_i8pair_u32": "h2_s"}
    split = {v: 0.0 for v in keys.values()}
    split["h1_check_s"] = 0.0
    events: dict[str, list] = {"h1_s": [], "h2_s": []}
    saved = {(owner, name): getattr(owner, name)
             for owner, names in patched.items() for name in names}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev = None
            if key in events:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*args, **kwargs)
            if ev is not None:
                ev[1].record()
                events[key].append(ev)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t
            if key == "h1_s" and check_h1 is not None:
                t = time.perf_counter()
                check_h1(out, *args, **kwargs)
                split["h1_check_s"] = time.perf_counter() - t
            return out
        return run

    for (owner, name), fn in saved.items():
        setattr(owner, name, timed(keys[name], fn))
    try:
        yield split
    finally:
        for (owner, name), fn in saved.items():
            setattr(owner, name, fn)
    split["glue_s"] = split["setup_s"] - split["h1_s"] - split["h2_s"] \
        - split["install_a2_s"] - split["h1_check_s"]
    for key, evs in events.items():
        split[key.replace("_s", "_device_ms")] = [a.elapsed_time(b)
                                                   for a, b in evs]


def ptxas_forms(stem: str, params: tuple) -> dict:
    """Registers and spill bytes of each compiled form of the kernel in
    csrc/<stem>.cu, keyed by its template arguments (named ``params``,
    e.g. ntw4_sw8), from its build's -Xptxas -v report (empty without
    one)."""
    from sdk_tpu_torch import _build

    out = {}
    for name, use in _build.ptxas_usage(stem).items():
        m = re.search(r"kernelI((?:Li\d+E)+)E", name)
        key = "_".join(f"{p}{v}" for p, v in zip(
            params, re.findall(r"\d+", m.group(1)))) if m else name
        out[key] = use
    return out


def residues(params, gen: np.random.Generator, lead: tuple, dev):
    x = np.stack([gen.integers(0, q, lead + (params.poly_len,))
                  for q in params.moduli], axis=-2)
    return torch.from_numpy(x.astype(np.int32)).to(dev)


def query_cols(params, gen, z: int, R: int, dev) -> torch.Tensor:
    return torch.stack([torch.from_numpy(
        gen.integers(0, q, (z, 1 << params.db_dim_1, R)).astype(np.int32))
        for q in params.moduli]).to(dev)


class KernelTable:
    """Rows of the kernel report; every number measured in this run."""

    def __init__(self):
        self.rows: dict[str, dict] = {}

    def check(self, name: str, label: str, err: int) -> None:
        """Record one kernel-vs-plain comparison; any difference fails."""
        row = self.rows.setdefault(name, {"name": name, "max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err != 0:
            raise AssertionError(f"{name} at {label}: kernel != plain "
                                 f"(max abs err {err})")

    def timed(self, name, source, replaces, shape, ms, plain_ms, bnd: dict,
              library_ms=None, **extra):
        """The kernel's row: where it comes from, its timed shape, its time
        beside its plain version's, its bound and the library yardstick."""
        self.rows[name].update(route="cuda", source=source, replaces=replaces,
                               launches=0, ms=ms, plain_ms=plain_ms, **bnd,
                               library_ms=library_ms, shape=shape, **extra)


class Launches:
    """Kernel launches of the main path, summed over the phases that drive
    it. Each phase resets the counts just before its reads and adds them
    just after."""

    def __init__(self):
        self.total: dict[str, int] = {}

    def run(self, fn):
        from sdk_tpu_torch import _build

        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        for k, v in counts.items():
            self.total[k] = self.total.get(k, 0) + v
        return out, counts


@contextlib.contextmanager
def expansion_launches():
    """Yields a list that gets, for each call of the engine's expand_queries
    made inside the block, the hand launches that call made. The wrapper
    only reads the counts before and after the call: it launches nothing,
    so the main path's totals are unchanged."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops.server import SpiralServerTorch

    calls: list[dict] = []
    expand = SpiralServerTorch.expand_queries

    def counted(self, *args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = expand(self, *args, **kwargs)
        calls.append({k: v - before[k] for k, v in _build.LAUNCHES.items()
                      if v != before[k]})
        return out

    SpiralServerTorch.expand_queries = counted
    try:
        yield calls
    finally:
        SpiralServerTorch.expand_queries = expand


def phase_kernels(params, dev, table: KernelTable) -> None:
    from sdk_tpu_torch.ops import ntt, spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    gen = np.random.default_rng(SEED)
    # A / A': 4096 polys x 2 channels, reduced and digit-range inputs
    x = residues(params, gen, (4096,), dev)
    digits = torch.from_numpy(gen.integers(0, 1 << 19, (4096, 2, 2048))
                              .astype(np.int32)).to(dev)
    # any uint32 bit pattern: 4q and above are reduced as they are loaded
    any_u32 = gen.integers(0, 1 << 32, (256, 2, 2048), dtype=np.uint64)
    any_u32[0, :, :4] = [4 * params.moduli[0], 4 * params.moduli[1],
                         1 << 31, (1 << 32) - 1]
    any_u32 = torch.from_numpy(any_u32.astype(np.uint32).view(np.int32)).to(dev)
    src = "sdk_tpu_torch/csrc/ntt.cu"
    tables = ntt.tables(params, dev)

    def ntt_bound(inp):
        # 1024 butterflies per stage x 11 stages per poly, ~6 integer ops each
        ops = BUTTERFLY_OPS * inp.numel() // 2 * params.poly_len_log2
        return bound(2 * nbytes(inp) + nbytes(tables), ops, INT32_OPS_PER_S)

    # 24 and 6,144 polynomials (the expansion's rounds r = 1 and 9 before
    # kernel E: 12 B of them, B = 2^r) and the read path's 65,536 (the
    # 16-batch's fold input, from_ntt at ops/shard.py:285)
    path = {n: residues(params, gen, (n // 2,), dev) for n in (24, 6144, 65536)}
    for name, fn, plain, replaces, inputs in (
            ("ntt_forward", ntt.ntt_forward, ntt.ntt_forward_plain,
             "sdk_tpu/ops/ntt_jax.py:199", (x, digits, any_u32)),
            ("ntt_inverse", ntt.ntt_inverse, ntt.ntt_inverse_plain,
             "sdk_tpu/ops/ntt_jax.py:215", (x,))):
        for i, inp in enumerate(inputs):
            table.check(name, ("residues", "digits", "any uint32")[i],
                        max_abs_err(fn(params, inp), plain(params, inp)))
        extra = {}
        for n, inp in path.items():
            table.check(name, f"{n} polynomials", max_abs_err(
                fn(params, inp), plain(params, inp)))
            torch.cuda.empty_cache()
            extra.update({
                f"polys{n}_ms": cuda_ms(lambda: fn(params, inp), 20),
                f"polys{n}_bound_ms": ntt_bound(inp)["bound_ms"]})
        table.timed(name, src, replaces, "(4096, 2, 2048) int32 residues; "
                    "24, 6144 and 65536 polynomials in the other keys",
                    cuda_ms(lambda: fn(params, x), 20),
                    cuda_ms(lambda: plain(params, x), 3), ntt_bound(x),
                    **extra)
    del path

    # B: regev_to_gsw's key product, (NQ, 2, 2*t_conv) keyed x (NQ, 42,
    # 2*t_conv, 1) at NQ = 1 and 16 (its only launch on the read path);
    # the shapes it used to have: the keyed expansion product (2, t_exp) x
    # (512, t_exp, 1) and the fold's [V_neg|V_fold] @ digits; the keyed v1
    # pack product
    ell = 2 * params.t_gsw
    it_half = params.instances * params.n * params.n * (1 << params.db_dim_2) // 2
    t_exp = params.t_exp_left
    tc2 = 2 * params.t_conv
    n_gsw = params.t_gsw * params.db_dim_2

    def keyed(m):
        return (m, u32_bits(shoup_companion_arr(
            params, m.cpu().numpy().astype(np.uint64)), dev))

    cases = {
        "regev_to_gsw NQ=16": (keyed(residues(params, gen, (16, 2, tc2), dev)),
                               residues(params, gen, (16, n_gsw, tc2, 1), dev)),
        "regev_to_gsw NQ=1": (keyed(residues(params, gen, (1, 2, tc2), dev)),
                              residues(params, gen, (1, n_gsw, tc2, 1), dev)),
        "expansion keyed": (keyed(residues(params, gen, (2, t_exp), dev)),
                            residues(params, gen, (512, t_exp, 1), dev)),
        "fold": (residues(params, gen, (2, 2 * ell), dev),
                 residues(params, gen, (it_half, 2 * ell, 1), dev)),
        "pack v1 keyed": (
            keyed(residues(params, gen, (params.n + 1, params.t_conv), dev)),
            residues(params, gen, (params.t_conv, 1), dev))}
    b_ms, b_bound = {}, {}
    for label, (a, b) in cases.items():
        a_plain = a[0] if isinstance(a, tuple) else a
        table.check("matmul_mod", label, max_abs_err(
            sj.matmul_mod(params, a, b),
            sj.matmul_mod_plain(params, a_plain, b)))
        k = b.shape[-4]
        out_numel = b.numel() // k * a_plain.shape[-4]
        b_ms[label] = cuda_ms(lambda: sj.matmul_mod(params, a, b), 20)
        b_bound[label] = bound(nbytes(*(a if isinstance(a, tuple) else (a,)), b)
                               + 4 * out_numel, 2 * out_numel * k,
                               INT32_OPS_PER_S)
    head = "regev_to_gsw NQ=16"
    a, b = cases[head]
    table.timed("matmul_mod", "sdk_tpu_torch/csrc/matmul_mod.cu",
                "sdk_tpu/ops/spiral_jax.py:108",
                f"{head}: keyed {tuple(a[0].shape)} x {tuple(b.shape)} int32 "
                f"(regev_to_gsw of a 16-batch); NQ=1, the old expansion and "
                f"fold shapes in the other keys",
                b_ms[head], cuda_ms(lambda: sj.matmul_mod_plain(
                    params, a[0], b), 3), b_bound[head],
                **{f"{k.replace(' ', '_').replace('=', '')}_ms": v
                   for k, v in b_ms.items() if k != head},
                **{f"{k.replace(' ', '_').replace('=', '')}_bound_ms":
                   v["bound_ms"] for k, v in b_bound.items() if k != head})
    del cases
    check_regev_to_gsw(params, dev, table, gen)

    # D: one packed response (instances, n+1, n, z) in [0, Q), with edges
    plan = ResponseEncodePlan(params, dev)
    packed = torch.from_numpy(gen.integers(
        0, params.modulus, (params.instances, params.n + 1, params.n,
                            params.poly_len), dtype=np.int64))
    packed[0, 0, 0, :3] = torch.tensor([0, params.modulus - 1,
                                        params.modulus // 2])
    packed = packed.to(dev)
    table.check("encode", "packed response", max_abs_err(
        plan.encode(packed), plan.encode_plain(packed)))
    table.timed("encode", "sdk_tpu_torch/csrc/encode.cu",
                "sdk_tpu/ops/encode_jax.py:99",
                f"{tuple(packed.shape)} int64 -> {plan.num_words} words",
                cuda_ms(lambda: plan.encode(packed), 20),
                cuda_ms(lambda: plan.encode_plain(packed), 3),
                bound(nbytes(packed) + 4 * plan.num_words,
                      10 * packed.numel(), INT32_OPS_PER_S))


def regev_to_gsw_case(params, gen: np.random.Generator, nq: int, dev,
                      sparse: bool = False):
    """The regev_to_gsw kernel's inputs at nq queries: the canonical leaves
    of a dense expansion (or of an S1 sparse one: 100 populated first-dim
    rows, at most half of them), a GSW leaf of query 0 all zero, each query's keyed conversion
    key, the GSW leaves' positions and the gadget's NTT."""
    from sdk_tpu_torch import poly as hpoly
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    right = params.t_gsw * params.db_dim_2
    if sparse:
        dim0 = 1 << params.db_dim_1
        pop = gen.choice(dim0, min(100, dim0 // 2), replace=False).tolist()
        splan = sj.SparseExpansionPlan(params, pop, right, dev)
        n_leaves = splan.schedule[-1].n_out
        pos = splan.odd_leaf_pos
    else:
        n_leaves = 1 << params.g()
        pos = torch.arange(1, 2 * right, 2, dtype=torch.int32, device=dev)
    leaves = residues(params, gen, (nq, n_leaves, 2, 1), dev)
    leaves[0, int(pos[1])] = 0
    pps = []
    for _ in range(nq):
        w = residues(params, gen, (2, 2 * params.t_conv), dev)
        pps.append({"v_exp_left": [], "v_exp_right": [], "v_conversion": (
            w, u32_bits(shoup_companion_arr(
                params, w.cpu().numpy().astype(np.uint64)), dev))})
    gadget = u32_bits(hpoly.to_ntt(params, hpoly.build_gadget(
        params, 2, 2 * params.t_gsw)), dev)
    return leaves, pos, sj.ExpansionKeys(params, pps), gadget, pps


def regev_to_gsw_chain(params, leaves, pos, pps, gadget):
    """What the engine ran before the regev_to_gsw kernel, through kernels
    A', A and B and the torch glue: the batch's keys stacked, the GSW
    leaves gathered, regev_to_gsw, then get_v_folding_neg."""
    from sdk_tpu_torch.ops import spiral as sj

    v_conv = tuple(torch.stack(k) for k in zip(
        *(pp["v_conversion"] for pp in pps)))
    v_inp = leaves.index_select(1, pos.long())
    raw = sj.from_ntt(params, v_inp)
    ginv = sj.gadget_digits(params, raw, 2 * params.t_conv, 2)
    vf = sj._gsw_layout(params, sj.matmul_mod(params, v_conv, sj.to_ntt(
        params, ginv)), v_inp)
    return vf, sj.get_v_folding_neg(params, vf, gadget)


def regev_to_gsw_bound(params, leaves, pos, gadget) -> dict:
    """Bytes: the GSW leaves, the keys with their companions and the
    gadget read once, both outputs written once; operations: 4 inverse and
    4 t_conv forward one-channel transforms a (query, leaf)."""
    nq, n_gsw = leaves.shape[0], pos.numel()
    n = params.poly_len
    leaf_bytes = 2 * params.crt_count * n * 4
    out_bytes = 2 * nq * params.db_dim_2 * 2 * 2 * params.t_gsw \
        * params.crt_count * n * 4
    moved = nq * n_gsw * leaf_bytes + nq * 2 * 2 * 2 * params.t_conv \
        * params.crt_count * n * 4 + nbytes(gadget) + out_bytes
    ops = nq * n_gsw * (4 + 4 * params.t_conv) * (n // 2) \
        * params.poly_len_log2 * BUTTERFLY_OPS
    return bound(moved, ops, INT32_OPS_PER_S)


def check_regev_to_gsw(params, dev, table: KernelTable,
                       gen: np.random.Generator) -> None:
    """The regev_to_gsw kernel against its plain version at NQ = 1 and 16
    on dense and S1 sparse leaves, timed beside the chain it replaced, its
    bound, its blocks an SM and the build's registers and spills; the
    grid (cluster, blocks, waves) is logged, worked out from the tiling."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj

    name = "regev_to_gsw"
    n_gsw = params.t_gsw * params.db_dim_2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = _build.lib()["sdk_regev_to_gsw_occupancy"]()
    extra = {"blocks_per_sm": per_sm,
             "ptxas": _build.ptxas_usage("regev_to_gsw")}
    grid = {}                  # configuration and arithmetic, not measured
    for nq in (16, 1):
        for sparse in (False, True):
            leaves, pos, keys, gadget, pps = regev_to_gsw_case(
                params, gen, nq, dev, sparse)
            got = sj.regev_to_gsw_neg(params, leaves, pos, keys, gadget)
            want = sj.regev_to_gsw_neg_plain(params, leaves, pos, keys,
                                             gadget)
            label = f"NQ={nq} {'S1 sparse' if sparse else 'dense'} leaves"
            for g, w in zip(got, want):
                table.check(name, label, max_abs_err(g, w))
            del got, want
            if sparse:
                continue
            cluster = sj.regev_to_gsw_tiling(nq * n_gsw, sms)
            blocks = nq * n_gsw * cluster
            grid[nq] = (f"NQ={nq} cluster {cluster}, {blocks} blocks, "
                        + (f"{blocks / (per_sm * sms):.3f} waves"
                           if per_sm > 0 else "waves unknown"))
            bnd = regev_to_gsw_bound(params, leaves, pos, gadget)
            extra.update({
                f"nq{nq}_ms": cuda_ms(lambda: sj.regev_to_gsw_neg(
                    params, leaves, pos, keys, gadget), 20),
                f"nq{nq}_bound_ms": bnd["bound_ms"],
                f"nq{nq}_bound_by": bnd["bound_by"],
                f"nq{nq}_chain_ms": cuda_ms(lambda: regev_to_gsw_chain(
                    params, leaves, pos, pps, gadget), 20)})
            if nq == 16:
                head = (leaves, pos, keys, gadget, bnd)
            else:
                del leaves, keys, pps
    leaves, pos, keys, gadget, bnd = head
    table.timed(
        name, "sdk_tpu_torch/csrc/regev_to_gsw.cu",
        "sdk_tpu/ops/spiral_jax.py:787",
        f"NQ=16: leaves {tuple(leaves.shape)} of a dense expansion, {n_gsw} "
        f"GSW leaves a query -> folding keys and their negations "
        f"(16, {params.db_dim_2}, 2, {2 * params.t_gsw}, 2, "
        f"{params.poly_len}) each; nq1_* one query; nq*_chain_ms the chain "
        f"it replaced (A', A, B and the torch glue, then get_v_folding_neg "
        f"at sdk_tpu/ops/spiral_jax.py:809); checked on S1 sparse leaves too",
        extra["nq16_ms"], cuda_ms(lambda: sj.regev_to_gsw_neg_plain(
            params, leaves, pos, keys, gadget), 2), bnd, **extra)
    log(f"[regev_to_gsw] NQ=16 {extra['nq16_ms']:.4f} ms (chain "
        f"{extra['nq16_chain_ms']:.4f}), NQ=1 {extra['nq1_ms']:.4f} ms (chain "
        f"{extra['nq1_chain_ms']:.4f}); bound {bnd['bound_ms']:.4f} ms; "
        f"{per_sm} blocks an SM; {extra['ptxas']}; grid (from the "
        f"tiling, not measured): {grid[16]}; {grid[1]}")
    del head, leaves, keys
    torch.cuda.empty_cache()


def regev_to_gsw_device_times(params, dev, table: KernelTable,
                              gen: np.random.Generator) -> None:
    """Device time of the regev_to_gsw kernel and of the chain it replaced
    (every kernel of it) at NQ = 1 and 16; the NQ = 1 latency bound: one
    inverse and one forward transform of a pair, which every leaf's
    digits wait for (A' and A on (1, 2, z))."""
    from sdk_tpu_torch.ops import ntt, spiral as sj

    row = table.rows["regev_to_gsw"]
    pair = residues(params, gen, (1,), dev)
    t_fwd = device_ms(lambda: ntt.ntt_forward(params, pair), "ntt_kernel", 20)
    t_inv = device_ms(lambda: ntt.ntt_inverse(params, pair), "ntt_kernel", 20)
    row["nq1_latency_bound_ms"] = (None if t_fwd is None or t_inv is None
                                   else t_fwd + t_inv)
    for nq in (1, 16):
        leaves, pos, keys, gadget, pps = regev_to_gsw_case(params, gen, nq,
                                                           dev)
        row[f"nq{nq}_device_ms"] = device_ms(
            lambda: sj.regev_to_gsw_neg(params, leaves, pos, keys, gadget),
            "regev_to_gsw_kernel", 10)
        row[f"nq{nq}_chain_device_ms"] = device_ms(
            lambda: regev_to_gsw_chain(params, leaves, pos, pps, gadget), "",
            10)
        del leaves, keys, pps
    row["device_ms"] = row["nq16_device_ms"]
    log(f"[device times] regev_to_gsw NQ=1 {row['nq1_device_ms']} ms (chain "
        f"{row['nq1_chain_device_ms']}, latency bound "
        f"{row['nq1_latency_bound_ms']}), NQ=16 {row['nq16_device_ms']} ms "
        f"(chain {row['nq16_chain_device_ms']})")


def transform_ops(n_two_channel: int, params) -> int:
    """Integer operations of n two-channel 2048-point transforms."""
    return (n_two_channel * 2 * (params.poly_len // 2) * params.poly_len_log2
            * BUTTERFLY_OPS)


def pack_critical_path(params, mode: str) -> tuple:
    """The longest chain of dependent two-channel transforms in the function
    kernel G computes (csrc/pack.cu), as (forward, inverse) counts, from
    pack's dataflow whatever a kernel's tiling: the n r's are independent
    until the v_int sum, and so are the 1 + t_conv forward transforms of
    one step; r = n - 1's chain is one forward step and, for version 1, n -
    1 shift steps of an inverse and a forward step; then, but for the NTT
    output, one inverse of the summed rows."""
    steps = params.n - 1 if params.version else 0
    return 1 + steps, steps + (0 if mode == "ntt" else 1)


def fold_case(params, gen: np.random.Generator, nq: int, in_slots: int, dev):
    """A fold round's input at NQ queries (per-query keys): random raw cts
    of (nq, it, in_slots) slots with a == 0, b == 0 and both zero planted
    in query 0."""
    it = params.instances * params.n * params.n
    cts = torch.from_numpy(gen.integers(
        0, params.modulus, (nq, it, in_slots, 2, 1, params.poly_len),
        dtype=np.int64))
    half = in_slots // 2
    cts[0, 0, 0] = 0                      # a == 0: takes b
    cts[0, 1, half] = 0                   # b == 0: takes a
    cts[0, 2, 0] = 0
    cts[0, 2, half] = 0                   # both: stays zero
    keys = [residues(params, gen, (nq, params.db_dim_2, 2, 2 * params.t_gsw),
                     dev) for _ in range(2)]
    return cts.to(dev), keys[0], keys[1]


def check_pack(params, dev, table: KernelTable,
               gen: np.random.Generator) -> None:
    """G against its plain versions in its three output modes at the 1 GiB
    bucket's shapes, NQ = 1 and 16 with per-query keys, and at version 0
    (the fast test params); each mode timed; its row."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan
    from sdk_tpu_torch.params import get_fast_expansion_testing_params

    z = params.poly_len

    def pack_case(prm, nq: int):
        nkeys = prm.n if prm.version == 0 else 2
        keys = [[residues(prm, gen, (prm.n + 1, prm.t_conv), dev)
                 for _ in range(nkeys)] for _ in range(nq)]
        v_ct = torch.from_numpy(gen.integers(
            0, prm.modulus, (nq, prm.instances, prm.n * prm.n, 2, 1,
                             prm.poly_len), dtype=np.int64))
        v_ct[0, 0, 0] = 0
        v_ct[nq - 1, 0, 1, :, 0, :3] = torch.tensor(
            [0, prm.modulus - 1, prm.modulus // 2])
        return v_ct.to(dev), keys

    def pack_check(prm, nq: int, label: str):
        v_ct, keys = pack_case(prm, nq)
        plan = ResponseEncodePlan(prm, dev)
        got = {"ntt": sj.pack_queries(prm, v_ct, keys),
               "raw": sj.pack_queries(prm, v_ct, keys, raw=True),
               "words": sj.pack_encode(prm, v_ct, keys, plan)}
        want = sj.pack_queries_plain(prm, v_ct, keys)
        raw = sj._from_ntt_plain(prm, want)
        words = torch.stack([plan.encode_plain(p) for p in raw])
        tl = sj.pack_tiling(prm, nq, sj._sm_count(dev))
        for mode, w in (("ntt", want), ("raw", raw), ("words", words)):
            table.check("pack", f"{label} NQ={nq} ({tl.cluster} block(s) a "
                        f"column), every query, {mode}",
                        max_abs_err(got[mode], w))
        return v_ct, keys, plan

    fast = get_fast_expansion_testing_params()
    for nq in (1, 16):
        pack_check(fast, nq, "version 0")
    pack_ms = {}
    n, tc = params.n, params.t_conv
    for nq in (1, 16):
        v_ct, keys, plan = pack_check(params, nq, f"version {params.version}")
        for mode in sj.PACK_MODES:
            pack_ms[f"nq{nq}_{mode}"] = cuda_ms(lambda: sj._pack_launch(
                params, v_ct, keys, mode, plan), 20)
        if nq == 1:
            plain_ms = cuda_ms(lambda: sj.pack_encode_plain(
                params, v_ct, keys, plan), 2)
            # per (instance, column): per r, 1 + t_conv forward transforms,
            # r shift steps of 1 inverse + t_conv forward (version 1); the
            # final inverse of n+1 rows; (n+1) rows x 2z multiply-adds a
            # digit; the compose and rescale of (n+1) z values
            steps = sum(range(n)) if params.version else 0
            per_block = (transform_ops(n * (1 + tc) + steps * (1 + tc) + n + 1,
                                       params)
                         + (n + steps) * tc * (n + 1) * 2 * z * 2
                         + (n + 1) * z * 30)
            bnd = bound(nbytes(v_ct) + nbytes(*keys[0]) + 4 * plan.num_words,
                        params.instances * n * per_block, INT32_OPS_PER_S)
            shape = (f"{tuple(v_ct.shape)} int64 -> {plan.num_words} words "
                     f"(out_words: pack + from_ntt + encode)")
    sms = sj._sm_count(dev)
    tl = {nq: sj.pack_tiling(params, nq, sms) for nq in (1, 16)}
    table.timed("pack", "sdk_tpu_torch/csrc/pack.cu",
                "sdk_tpu/ops/spiral_jax.py:878", shape, pack_ms["nq1_words"],
                plain_ms, bnd, None,
                **{f"{k}_ms": v for k, v in pack_ms.items()},
                pairs=tl[1].pairs, nq1_cluster=tl[1].cluster,
                nq16_cluster=tl[16].cluster,
                blocks_per_sm=_build.lib()["sdk_pack_occupancy"](
                    params.n, params.version, tl[1].pairs),
                ptxas=_build.ptxas_usage("pack"))
    log(f"[kernels] G equals its plain version (version 0 and 1, NQ = 1 and "
        f"16, NTT, raw and word outputs); "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in pack_ms.items()))


def phase_fused_kernels(params, dev, table: KernelTable) -> None:
    """F, G and H against their plain versions at the 1 GiB bucket's shapes,
    and G and H once on other parameter sets (version 0; p = 16)."""
    from sdk_tpu_torch.kv import ingest as ing
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params import params_from_json

    gen = np.random.default_rng(SEED + 7)
    z = params.poly_len
    it = params.instances * params.n * params.n
    num_per = 1 << params.db_dim_2
    ell = 2 * params.t_gsw

    # ---- F: every round (num_per -> num_per/2: 512 slots a query, ..., 2 ->
    # 1: 16 slots), NQ = 1 and 16, per-query keys
    def fold_bound(cts, nq):
        a, b = cts[:, :, :cts.shape[2] // 2], cts[:, :, cts.shape[2] // 2:]
        live = int((a.flatten(3).any(-1) & b.flatten(3).any(-1)).sum())
        # per live slot: 2*ell forward + 2 inverse two-channel transforms,
        # 2*ell digit polys x 2 rows x 2 channels x z multiply-adds
        ops = live * (transform_ops(2 * ell + 2, params) + 2 * 2 * ell * 4 * z)
        key_bytes = nq * 2 * 2 * ell * 2 * z * 4
        return bound(nbytes(cts) + nbytes(cts) // 2 + key_bytes, ops,
                     INT32_OPS_PER_S), live

    fold_ms, whole = {}, {}
    for nq in (1, 16):
        for r in range(params.db_dim_2):
            in_slots, key = num_per >> r, params.db_dim_2 - 1 - r
            cts, vn, vf = fold_case(params, gen, nq, in_slots, dev)
            got = sj._fold_round_launch(params, cts, vn, vf, key, 1)
            for q in range(nq):                 # plain: a query a time
                table.check("fold_round", f"round {r} NQ={nq} query {q}",
                            max_abs_err(got[q:q + 1], sj.fold_round_plain(
                                params, cts[q:q + 1], vn[q:q + 1, key],
                                vf[q:q + 1, key])))
            if not (torch.equal(got[0, 0, 0], cts[0, 0, in_slots // 2])
                    and torch.equal(got[0, 1, 0], cts[0, 1, 0])
                    and not got[0, 2, 0].any()):
                raise AssertionError("fold_round: zero slots not verbatim")
            bnd, live = fold_bound(cts, nq)
            fold_ms[(nq, r)] = {
                "ms": cuda_ms(lambda: sj._fold_round_launch(
                    params, cts, vn, vf, key, 1), 10),
                "bound_ms": bnd["bound_ms"], "live_slots": live,
                "tiling": "cluster {}".format(
                    *sj.fold_tiling(nq * it * in_slots // 2, params.t_gsw))}
            if r == 0:
                if nq == 1:
                    plain_ms = cuda_ms(lambda: sj.fold_round_plain(
                        params, cts, vn[:, key], vf[:, key]), 2)
                    shape = f"{tuple(cts.shape)} int64 -> {tuple(got.shape)}"
                    bnd0 = bnd
                whole[nq] = cuda_ms(lambda: sj.fold_ciphertexts(
                    params, cts, vf, vn), 5)
            del cts, vn, vf, got
    from sdk_tpu_torch import _build

    extra = {"whole_fold_ms_nq1": whole[1], "whole_fold_ms_nq16": whole[16],
             "blocks_per_sm": _build.lib()["sdk_fold_round_occupancy"](),
             "ptxas": _build.ptxas_usage("fold_round")}
    for (nq, r), row in fold_ms.items():
        extra.update({f"nq{nq}_round{r}_{k}": v for k, v in row.items()})
    table.timed("fold_round", "sdk_tpu_torch/csrc/fold_round.cu",
                "sdk_tpu/ops/spiral_jax.py:818",
                f"round 0 of one query's fold: {shape}, keys (1, "
                f"{params.db_dim_2}, 2, {ell}, 2, {z}) int32 x 2; every "
                f"round at NQ = 1 and 16 and the whole fold in the other keys",
                fold_ms[(1, 0)]["ms"], plain_ms, bnd0, None, **extra)
    log(f"[kernels] F equals its plain version (every round, NQ = 1 and 16, "
        f"zero slots verbatim); round 0 NQ=1 {fold_ms[(1, 0)]['ms']:.4f} ms, "
        f"NQ=16 {fold_ms[(16, 0)]['ms']:.4f} ms, whole fold NQ=1 "
        f"{whole[1]:.4f} ms, NQ=16 {whole[16]:.4f} ms")

    check_pack(params, dev, table, gen)

    # ---- H: 256 and 1,024 items into a dense tensor, into compact planes at
    # cap 8, over a prefilled index
    K = min(256, params.num_items() // 8, 8 * num_per)   # 256 at 1 GiB
    K4 = 4 * K                               # 1,024: a fill's flush chunk
    raw4 = torch.from_numpy(gen.integers(
        0, 256, (K4, it, params.bytes_per_chunk()), dtype=np.uint8)).to(dev)
    raw4[3] = 0
    raw = raw4[:K]
    ing_ms = {}

    def ingest_check(prm, target_shape, idxs, rawb, label: str,
                     prefilled: bool = False):
        idxs = np.asarray(sorted(idxs))
        npr = 1 << prm.db_dim_2
        bins, cols = idxs % npr, idxs // npr
        if prefilled:
            got = torch.randint(0, 128, target_shape, dtype=torch.int8,
                                device=dev)
            want = got.clone()
        else:
            got = torch.zeros(target_shape, dtype=torch.int8, device=dev)
            want = torch.zeros(target_shape, dtype=torch.int8, device=dev)
        ing.ingest_into(prm, got, bins, cols, rawb)
        sj.db_write_items(prm, want, bins, cols, ing.ingest_plain(prm, rawb))
        table.check("ingest", label, 0 if torch.equal(got, want) else 1)
        table.check("ingest", label + ", residues", max_abs_err(
            ing.ingest_items_device(prm, rawb), ing.ingest_plain(prm, rawb)))
        ms = cuda_ms(lambda: ing.ingest_into(prm, got, bins, cols, rawb), 10)
        plain = cuda_ms(lambda: sj.db_write_items(
            prm, want, bins, cols, ing.ingest_plain(prm, rawb)), 2)
        del got, want
        return ms, plain, (bins, cols)

    def sector_bound_ms(prm, bins, cols, rawb) -> float:
        """Bytes of every sector the items touch, read (a partial sector)
        and written whole, at the HBM rate: the bound of a writer of whole
        sectors."""
        plan = ing.sector_plan(1 << prm.db_dim_2, it, bins, cols)
        sectors = it * 2 * z * sj.NUM_LIMBS
        full = int(plan.groups[:, 1].sum())
        part = len(plan.groups) - full
        moved = nbytes(rawb) + sectors * plan.members * (full + 2 * part)
        return moved / HBM_BYTES_PER_S * 1e3

    dense_shape = sj.db_shape(params)
    ms, plain_ms, _ = ingest_check(params, dense_shape, range(2 * K, 3 * K),
                                   raw, f"{K} neighbouring items, dense")
    ms4, plain4, _ = ingest_check(params, dense_shape, range(K4, 2 * K4), raw4,
                                  f"{K4} neighbouring items, dense")
    scat, _, (sb, sc) = ingest_check(
        params, dense_shape, gen.choice(params.num_items(), K, replace=False),
        raw, f"{K} scattered items, dense")
    ing_ms["scattered"] = scat
    # whole sectors, and one partial sector in each block of 4 columns: the
    # last 8 bins of the odd columns hold no item
    part_idx = [i for i in range(5 * K, 6 * K)
                if not (i % num_per >= num_per - 8 and (i // num_per) % 2)]
    ing_ms["partial"] = ingest_check(
        params, dense_shape, part_idx, raw4[:len(part_idx)],
        f"{len(part_idx)} items in whole and partial sectors over a "
        f"prefilled dense index", prefilled=True)[0]
    ing_ms["compact"] = ingest_check(
        params, sj.compact_shape(params, 8), range(K), raw,
        f"{K} items, compact cap 8")[0]
    p16 = params_from_json(P16)
    raw16 = torch.from_numpy(gen.integers(
        0, 256, (7, p16.instances * p16.n * p16.n, p16.bytes_per_chunk()),
        dtype=np.uint8)).to(dev)
    ingest_check(p16, sj.db_shape(p16), [0, 1, 2, 5, 9, 14, 15], raw16,
                 "p = 16, 7 items, dense")
    odd = params_from_json(P256_ODD)
    raw_odd = torch.from_numpy(gen.integers(
        0, 256, (7, odd.instances * odd.n * odd.n, odd.bytes_per_chunk()),
        dtype=np.uint8)).to(dev)
    for shape_odd, kind in ((sj.db_shape(odd), "dense"),
                            (sj.compact_shape(odd, 8), "compact cap 8")):
        ingest_check(odd, shape_odd, [0, 1, 2, 5, 9, 14, 15], raw_odd,
                     f"p = 256, {odd.bytes_per_chunk()}-byte chunks, 7 "
                     f"items, {kind}", prefilled=True)

    def h_bound(k: int) -> dict:
        return bound(k * it * params.bytes_per_chunk() + k * it * 2 * z * 4
                     + 16 * k, k * transform_ops(it, params), INT32_OPS_PER_S)

    out_bytes = K * it * 2 * z * 4
    table.timed("ingest", "sdk_tpu_torch/csrc/ingest.cu",
                "sdk_tpu/kv/ingest.py:61",
                f"{tuple(raw.shape)} uint8 -> {out_bytes} int8 limbs in place "
                f"in the dense DB tensor {dense_shape}, {K} neighbouring "
                f"items (whole sectors); {K4} neighbouring items (a fill's "
                f"flush chunk), scattered items (scattered_bound_ms: the "
                f"bytes of every sector they touch, read and written whole, "
                f"at the HBM rate), items in whole and partial sectors over a "
                f"prefilled index and compact planes at cap 8 in the other "
                f"keys",
                ms, plain_ms, h_bound(K), None,
                neighbouring_1024_ms=ms4,
                neighbouring_1024_bound_ms=h_bound(K4)["bound_ms"],
                neighbouring_1024_plain_ms=plain4,
                scattered_items_ms=ing_ms["scattered"],
                scattered_bound_ms=sector_bound_ms(params, sb, sc, raw),
                partial_prefilled_ms=ing_ms["partial"],
                compact_cap8_ms=ing_ms["compact"],
                ptxas=_build.ptxas_usage("ingest"))
    log(f"[kernels] H equals its plain version (dense {K} and {K4} "
        f"neighbouring, scattered, partial sectors over a prefilled index, "
        f"compact cap 8, p = 16, 251-byte chunks; limbs in place and "
        f"residues); {K} "
        f"neighbouring items {ms:.4f} ms, {K4} {ms4:.4f} ms, scattered "
        f"{ing_ms['scattered']:.4f} ms, partial {ing_ms['partial']:.4f} ms, "
        f"compact {ing_ms['compact']:.4f} ms; configuration: batches of "
        f"{ing.INGEST_BATCH_ITEMS} items")
    del raw4, raw, raw16, raw_odd



def pack_device_times(params, dev, table: KernelTable,
                      gen: np.random.Generator) -> None:
    """G's device time in each mode at NQ = 1 and 16, and its latency
    bound: the dependent transforms of one block's chain
    (pack_critical_path) times the device time of one core transform of one
    polynomial pair (A and A' on (1, 2, z): a group a channel)."""
    from sdk_tpu_torch.ops import ntt, spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan

    pair = residues(params, gen, (1,), dev)
    t_fwd = device_ms(lambda: ntt.ntt_forward(params, pair), "ntt_kernel", 20)
    t_inv = device_ms(lambda: ntt.ntt_inverse(params, pair), "ntt_kernel", 20)
    g = table.rows["pack"]
    g.update(pair_forward_device_ms=t_fwd, pair_inverse_device_ms=t_inv)
    plan = ResponseEncodePlan(params, dev)
    for nq in (1, 16):
        keys = [[residues(params, gen, (params.n + 1, params.t_conv), dev)
                 for _ in range(2 if params.version else params.n)]
                for _ in range(nq)]
        v_ct = torch.from_numpy(gen.integers(
            0, params.modulus, (nq, params.instances, params.n * params.n, 2,
                                1, params.poly_len), dtype=np.int64)).to(dev)
        for mode in sj.PACK_MODES:
            g[f"nq{nq}_{mode}_device_ms"] = device_ms(
                lambda: sj._pack_launch(params, v_ct, keys, mode, plan),
                "pack_kernel", 20)
        del keys, v_ct
    for mode in sj.PACK_MODES:
        fwd, inv = pack_critical_path(params, mode)
        g[f"{mode}_critical_path"] = {"forward": fwd, "inverse": inv}
        g[f"{mode}_latency_bound_ms"] = (
            None if t_fwd is None or t_inv is None else fwd * t_fwd + inv * t_inv)
    g["device_ms"] = g["nq1_words_device_ms"]
    g["latency_bound_ms"] = g["words_latency_bound_ms"]
    log(f"[device times] G out_words NQ=1 {g['nq1_words_device_ms']} ms, "
        f"NQ=16 {g['nq16_words_device_ms']} ms against a latency bound of "
        f"{g['latency_bound_ms']} ms ({g['words_critical_path']} dependent "
        f"transforms of a pair: {t_fwd} / {t_inv} ms)")


def k_device_times(dev, table: KernelTable, config: str = CHECKLIST) -> None:
    """Device time of kernel K's tiled form on the setup H1 sample (as
    phase_doublepir_kernels times it with CUDA events, which also carry the
    wrapper's add row), and of its narrow form on random digit planes of
    the answer's a_2 shape at nq = 8 and 1 (phase_checklist_full's events
    on the bucket's own planes)."""
    from sdk_tpu_torch.doublepir import server_torch as st
    from sdk_tpu_torch.doublepir.params import Params

    params = Params.from_string(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    row = table.rows["dp_dot_i8"]
    a1 = dev_u32(gen, (params.m, params.n), dev)
    db_rows = dev_i8(gen, (33 * 128, params.m), dev)
    row["tiled_device_ms"] = device_ms(
        lambda: st.dot_i8_u32(db_rows, a1, c=128 - params.p // 2),
        "dot_i8_tiled", 5)
    del a1, db_rows
    rows, l3 = params.n * params.delta(), -(-params.l // 3) * 3
    lo = dev_i8(gen, (rows, l3), dev, 0, 128)
    hi = dev_i8(gen, (rows, l3), dev, 0, 4)
    for nq in (8, 1):
        q2 = dev_u32(gen, (l3, nq), dev)
        row[f"a2_device_ms_nq{nq}"] = device_ms(
            lambda: st.dot_i8pair_u32(lo, hi, q2), "dot_i8_narrow", 10)
    log(f"[device times] K narrow form a_2 nq=8 {row['a2_device_ms_nq8']} "
        f"ms, nq=1 {row['a2_device_ms_nq1']} ms")
    del lo, hi, q2
    torch.cuda.empty_cache()


def m_device_times(params, dev, table: KernelTable) -> None:
    """Device time of kernel M at the sharded read's D = 4 partials and at
    R = 32 (check_psum_mod's events carry the wrapper's host time)."""
    from sdk_tpu_torch.ops.shard import psum_mod

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    row = table.rows["psum_mod"]
    for key, R in (("device_ms", 2), ("R32_device_ms", 32)):
        shape = (2, params.poly_len, params.instances, params.n * params.n // 2,
                 1 << params.db_dim_2, R)
        ps = [torch.randint(0, min(params.moduli), shape, generator=gen,
                            dtype=torch.int32, device=dev) for _ in range(4)]
        row[key] = device_ms(lambda: psum_mod(ps, params.moduli), "psum_mod",
                             20)
        del ps
    log(f"[device times] M D=4 read {row['device_ms']} ms, R=32 "
        f"{row['R32_device_ms']} ms")


def l_device_times(dev, table: KernelTable, config: str = CHECKLIST) -> None:
    """Device time of L's answer form (msg0 and h_2 in one launch) at the
    production config, nq = 8 and 1, and of the two packed launches it
    replaced at nq = 8."""
    from sdk_tpu_torch.doublepir import kernels as dk
    from sdk_tpu_torch.doublepir.params import Params

    params = Params.from_string(config)
    l3 = -(-params.l // 3) * 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    a2p = dev_u32(gen, (l3, params.n), dev)
    a_1t = dev_u32(gen, (params.delta(), l3 // 3), dev) & 0x3FFFFFFF
    row = table.rows["dp_matmul_u32"]
    for nq in (8, 1):
        q2 = dev_u32(gen, (l3, nq), dev)
        row[f"answer_nq{nq}_device_ms"] = device_ms(
            lambda: dk.answer_products(a_1t, a2p, q2), "answer_kernel", 10)
        if nq == 8:
            row["answer_parent_nq8_device_ms"] = device_ms(
                lambda: (dk.mat_mul_vec_packed(a_1t, a2p),
                         dk.mat_mul_vec_packed(a_1t, q2)),
                "matmul_u32_kernel", 10)
    row["device_ms"] = row["answer_nq8_device_ms"]
    log(f"[device times] L answer form nq=8 {row['answer_nq8_device_ms']} ms "
        f"(two packed launches before it {row['answer_parent_nq8_device_ms']}"
        f"), nq=1 {row['answer_nq1_device_ms']} ms")
    del a2p, a_1t, q2
    torch.cuda.empty_cache()


def ingest_device_times(params, dev, table: KernelTable,
                        gen: np.random.Generator) -> None:
    """H's device time (its transform and sector kernels) at the shapes
    phase_fused_kernels timed with CUDA events, which carry the host's
    sector plan and upload: 256 and 1,024 neighbouring items and 256
    scattered items into a dense index."""
    from sdk_tpu_torch.kv import ingest as ing
    from sdk_tpu_torch.ops import spiral as sj

    it = params.instances * params.n * params.n
    npr = 1 << params.db_dim_2
    db = torch.zeros(sj.db_shape(params), dtype=torch.int8, device=dev)
    raw = torch.from_numpy(gen.integers(
        0, 256, (1024, it, params.bytes_per_chunk()), dtype=np.uint8)).to(dev)
    row = table.rows["ingest"]
    for key, idxs in (("device_ms", np.arange(512, 768)),
                      ("neighbouring_1024_device_ms", np.arange(1024, 2048)),
                      ("scattered_items_device_ms", np.sort(gen.choice(
                          params.num_items(), 256, replace=False)))):
        b, c, r = idxs % npr, idxs // npr, raw[:len(idxs)]
        row[key] = device_ms(lambda: ing.ingest_into(params, db, b, c, r),
                             "_kernel", 10)
    del db, raw
    torch.cuda.empty_cache()


def phase_device_times(params, dev, table: KernelTable) -> None:
    """Device times of A, A', F, E, G, H, K, L and M from torch.profiler on
    fresh inputs of the shapes the kernel phases timed with CUDA events
    (which carry the wrapper's host time at small shapes). Run last: CUPTI's tracing stays
    attached to the process and slows every launch that follows a profiler
    session (tools/read_stages_gpu.py), so no wall time is taken after it."""
    from sdk_tpu_torch.ops import ntt, spiral as sj

    gen = np.random.default_rng(SEED + 9)
    for n in (8192, 24, 6144, 65536):
        x = residues(params, gen, (n // 2,), dev)
        for name, fn in (("ntt_forward", ntt.ntt_forward),
                         ("ntt_inverse", ntt.ntt_inverse)):
            key = "device_ms" if n == 8192 else f"polys{n}_device_ms"
            table.rows[name][key] = device_ms(lambda: fn(params, x),
                                              "ntt_kernel", 20)
        del x
    num_per = 1 << params.db_dim_2
    for nq in (1, 16):
        for r in range(params.db_dim_2):
            cts, vn, vf = fold_case(params, gen, nq, num_per >> r, dev)
            key = params.db_dim_2 - 1 - r
            table.rows["fold_round"][f"nq{nq}_round{r}_device_ms"] = device_ms(
                lambda: sj._fold_round_launch(params, cts, vn, vf, key, 1),
                "fold_round_kernel", 10)
            del cts, vn, vf
    plan = sj.ExpansionPlan(params, dev)
    sched = sj.dense_schedule(params, params.t_gsw * params.db_dim_2, dev)
    for nq in (1, 16):
        keys = sj.ExpansionKeys(params, expansion_key_sets(params, gen, nq,
                                                           dev))
        cts = expansion_inputs(params, gen, nq, dev)
        total = 0.0
        for r, rnd in enumerate(sched):
            ms = device_ms(lambda: sj.expansion_round(params, plan, r, cts,
                                                      rnd, keys),
                           "expansion_kernel", 10)
            table.rows["expansion"][f"dense_nq{nq}_round{r}_device_ms"] = ms
            total = None if ms is None or total is None else total + ms
            cts = sj.expansion_round(params, plan, r, cts, rnd, keys)
        table.rows["expansion"][f"dense_nq{nq}_whole_device_ms"] = total
        del cts, keys
    pack_device_times(params, dev, table, gen)
    torch.cuda.empty_cache()
    regev_to_gsw_device_times(params, dev, table, gen)
    ingest_device_times(params, dev, table, gen)
    k_device_times(dev, table)
    l_device_times(dev, table)
    m_device_times(params, dev, table)
    row = table.rows["fold_round"]
    log("[device times] torch.profiler: A 8192 polys "
        f"{table.rows['ntt_forward']['device_ms']} ms, A' "
        f"{table.rows['ntt_inverse']['device_ms']} ms; F NQ=1 rounds "
        + ", ".join(f"{row[f'nq1_round{r}_device_ms']}"
                    for r in range(params.db_dim_2)) + " ms; E whole dense "
        f"expansion NQ=1 {table.rows['expansion']['dense_nq1_whole_device_ms']}"
        f" ms, NQ=16 {table.rows['expansion']['dense_nq16_whole_device_ms']} "
        f"ms")


def random_rows(params, gen, idxs) -> dict:
    n = params.instances * params.n * params.n * params.bytes_per_chunk()
    return {i: gen.integers(0, 256, n, dtype=np.uint8).tobytes() for i in idxs}


def small_db(params, gen, dev):
    """Seeded random rows of every item and their dense index on ``dev``,
    written by the plain ingest on the CPU."""
    from sdk_tpu_torch.kv.ingest import DbUpdateBuffer
    from sdk_tpu_torch.ops import spiral as sj

    rows = random_rows(params, gen, range(params.num_items()))
    buf = DbUpdateBuffer(params, "cpu")
    for i, data in rows.items():
        buf.upsert_raw(i, data)
    return rows, buf.flush(torch.zeros(sj.db_shape(params),
                                       dtype=torch.int8)).to(dev)


def phase_small_configs(dev) -> None:
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.ops.server import SpiralServerTorch
    from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                      params_from_json)
    from sdk_tpu_torch.rng import ChaCha20Rng

    gen = np.random.default_rng(SEED + 2)
    for label, params in (("fast v0", get_fast_expansion_testing_params()),
                          ("V1_SMALL", params_from_json(V1_SMALL))):
        target = 23 % params.num_items()
        client = Client(params)
        pp = client.generate_keys_from_seed(
            b"\x21" * 32, noise_rng=ChaCha20Rng(b"\x22" * 32),
            pp_seed=b"\x23" * 32)
        query = client.generate_query(
            target, noise_rng=ChaCha20Rng(b"\x24" * 32),
            query_seed=b"\x25" * 32)
        rows, db = small_db(params, gen, "cpu")
        responses = []
        for device in (dev, "cpu"):
            srv = SpiralServerTorch(params, device)
            srv.set_db(db)
            responses.append(srv.process_query(pp, query))
        if responses[0] != responses[1]:
            raise AssertionError(f"{label}: card response differs from the "
                                 f"CPU plain versions'")
        decoded = client.decode_response(responses[0])
        if decoded[:len(rows[target])] != rows[target]:
            raise AssertionError(f"{label}: response does not decode")
        log(f"[small] {label}: {len(responses[0])} bytes, card == CPU plain "
            f"versions byte for byte, decodes")


def check_value(client, response: bytes, key: str, value: bytes) -> None:
    from sdk_tpu_torch.kv.key_value import extract_result

    payload = bz2.BZ2Decompressor().decompress(client.decode_response(response))
    if extract_result(key, payload) != value:
        raise AssertionError(f"read of {key!r} decoded to the wrong value")


class Sessions:
    """One client for single reads, four for the batch, keys made once and
    set up on every bucket the run builds."""

    def __init__(self, params):
        from sdk_tpu_torch.client import Client
        from sdk_tpu_torch.rng import ChaCha20Rng

        self.params = params
        self.clients, self.pp = [], []
        for ci in range(5):
            c = Client(params)
            self.pp.append(c.generate_keys_from_seed(
                bytes([0x50 + ci]) * 32,
                noise_rng=ChaCha20Rng(bytes([0x60 + ci]) * 32),
                pp_seed=bytes([0x70 + ci]) * 32).serialize(params))
            self.clients.append(c)

    def setup(self, srv) -> list[str]:
        return [srv.setup(json.dumps(base64.b64encode(pp).decode()).encode())
                for pp in self.pp]

    def blob(self, uids, ci: int, key: str, salt: int) -> bytes:
        from sdk_tpu_torch.kv.key_value import row_from_key
        from sdk_tpu_torch.rng import ChaCha20Rng

        q = self.clients[ci].generate_query(
            row_from_key(self.params.num_items(), key),
            noise_rng=ChaCha20Rng(bytes([salt % 256]) * 32),
            query_seed=bytes([(salt + 101) % 256]) * 32)
        return uids[ci].encode() + q.serialize(self.params)

    def drive(self, srv, uids, keys, values, salt: int, n_single: int,
              n_batch: int) -> dict:
        """n_single reads of keys through private_read, n_batch 16-query
        batches (4 sessions x 4 queries) through dispatch_read_blobs, every
        response decoded. Returns the wall times."""
        single = [self.blob(uids, 0, keys[i % len(keys)], salt + i)
                  for i in range(n_single)]
        batch_keys = [keys[i % len(keys)] for i in range(16)]
        batch = [self.blob(uids, 1 + i // 4, k, salt + 32 + i)
                 for i, k in enumerate(batch_keys)]
        lat, batch_s = [], []
        for i, b in enumerate(single):
            t = time.perf_counter()
            body = srv.private_read(json.dumps(
                [base64.b64encode(b).decode()]).encode())
            lat.append(time.perf_counter() - t)
            check_value(self.clients[0], base64.b64decode(json.loads(body)[0]),
                        keys[i % len(keys)], values[keys[i % len(keys)]])
        for _ in range(n_batch):
            t = time.perf_counter()
            resps = srv.dispatch_read_blobs(batch)()
            batch_s.append(time.perf_counter() - t)
            for i, (key, resp) in enumerate(zip(batch_keys, resps)):
                check_value(self.clients[1 + i // 4], resp, key, values[key])
        return {"single_read_ms_median": float(np.median(lat)) * 1e3,
                "single_read_ms_all": [x * 1e3 for x in lat],
                "batch16_ms_median": float(np.median(batch_s)) * 1e3,
                "batch16_ms_all": [x * 1e3 for x in batch_s]}


def distinct_row_keys(n_items: int, count: int) -> list[str]:
    """count keys whose rows differ, so each row holds one 16 KiB value."""
    from sdk_tpu_torch.kv.key_value import row_from_key

    keys, rows = [], set()
    i = 0
    while len(keys) < count:
        key = f"key-{i:05d}"
        row = row_from_key(n_items, key)
        if row not in rows:
            rows.add(row)
            keys.append(key)
        i += 1
    return keys


def value_len(params) -> int:
    """16 KiB at the 1 GiB bucket (32 KiB rows)."""
    row = params.instances * params.n * params.n * params.bytes_per_chunk()
    return min(16384, row // 2)


def write_values(srv, values: dict) -> None:
    srv.write_kv(json.dumps({k: base64.b64encode(v).decode()
                             for k, v in values.items()}).encode())


def check_compact_scan(params, db, gen, table: KernelTable,
                       state: str) -> dict:
    """Kernel I against its plain version on a z-slice of the state's
    compact index at R = 2 and 32 (a single read and a 16-query batch), and
    timed on the whole index; returns the z-slice row and the whole-index
    times."""
    from sdk_tpu_torch.ops import spiral as sj

    zs = 64
    sl = sj.CompactDb(db.planes[:, :zs].contiguous(), db.idx_j)
    compact_bytes = nbytes(db.planes)
    npr = db.idx_j.shape[0]
    extra = {"cap_bin": db.cap_bin, "compact_bytes": compact_bytes,
             # torch._int_mm's int32 output over the same bytes at 32
             # columns, beside I's own output (full_index_out_bytes_R*)
             "library_out_bytes_R32": compact_bytes // 256 * 32 * 4}
    for R in (2, 32):
        q_full = query_cols(params, gen, params.poly_len, R, db.planes.device)
        q_sl = q_full[:, :zs].contiguous()
        got = sj.firstdim_multiply(params, sl, q_sl)
        table.check("scan_compact", f"{state} R={R} z-slice", max_abs_err(
            got, sj.firstdim_multiply_compact_plain(params, sl, q_sl)))
        table.check("scan_compact", f"{state} R={R} whole index", max_abs_err(
            sj.firstdim_multiply(params, db, q_full)[:, :zs], got))
        out_bytes = 4 * got.numel() * (params.poly_len // zs)
        extra[f"full_index_out_bytes_R{R}"] = out_bytes
        extra[f"tiling_R{R}"] = sj.compact_scan_tiling(
            R, npr, 1 << params.db_dim_1, db.cap_bin)._asdict()
        full_ms = cuda_ms(lambda: sj.firstdim_multiply(params, db, q_full), 5)
        b = bound(compact_bytes + nbytes(db.idx_j, q_full) + out_bytes,
                  2 * compact_bytes * 4 * R, INT8_OPS_PER_S)
        extra[f"full_index_ms_R{R}"] = full_ms
        extra[f"full_index_bound_ms_R{R}"] = b["bound_ms"]
        extra[f"full_index_bound_by_R{R}"] = b["bound_by"]
        extra[f"full_index_GBps_R{R}"] = compact_bytes / full_ms / 1e6
        extra[f"full_index_share_of_bound_R{R}"] = b["bound_ms"] / full_ms
        if R == 32:
            extra["ms_R32"] = cuda_ms(
                lambda: sj.firstdim_multiply(params, sl, q_sl), 10)
            extra["library_ms_R32"] = int_mm_ms(sl.planes, 32)
            extra["full_index_library_ms_R32"] = int_mm_ms(db.planes, 32)
        if R == 2:
            row = dict(
                ms=cuda_ms(lambda: sj.firstdim_multiply(params, sl, q_sl), 10),
                plain_ms=cuda_ms(lambda: sj.firstdim_multiply_compact_plain(
                    params, sl, q_sl), 2),
                bnd=bound(nbytes(sl.planes, sl.idx_j, q_sl, got),
                          2 * nbytes(sl.planes) * 4 * R, INT8_OPS_PER_S),
                library_ms=int_mm_ms(sl.planes))
        del q_full, q_sl, got
    extra["ms_R2"] = row["ms"]
    extra["plain_ms_R2"] = row["plain_ms"]
    extra["bound_ms_R2"] = row["bnd"]["bound_ms"]
    return {"row": row, "extra": extra}


def check_dense_scan(params, db, gen, table: KernelTable, label: str,
                     columns: tuple = (2, 32)) -> dict:
    """Kernel C against its plain version on a z-slice of a dense index and
    on the whole index at each R of ``columns`` (in its resident form,
    table row scan_resident, above 64); returns the z-slice rows of R = 2
    and of the widest R and the whole-index times."""
    from sdk_tpu_torch.ops import spiral as sj

    zs = 64
    db_slice = db[:, :zs].contiguous()
    index_bytes = nbytes(db)
    extra, row, wide = {}, {}, {}
    for R in columns:
        name = "scan_resident" if R > 64 else "scan"
        q_full = query_cols(params, gen, params.poly_len, R, db.device)
        q_slice = q_full[:, :zs].contiguous()
        got = sj.firstdim_multiply(params, db_slice, q_slice)
        table.check(name, f"R={R} z-slice of the {label}", max_abs_err(
            got, sj.firstdim_multiply_plain(params, db_slice, q_slice)))
        table.check(name, f"R={R} {label}", max_abs_err(
            sj.firstdim_multiply(params, db, q_full)[:, :zs], got))
        full_ms = cuda_ms(lambda: sj.firstdim_multiply(params, db, q_full), 5)
        b = bound(index_bytes + nbytes(q_full) + 4 * got.numel()
                  * (params.poly_len // zs), 2 * index_bytes * 4 * R,
                  INT8_OPS_PER_S)
        extra[f"full_index_ms_R{R}"] = full_ms
        extra[f"full_index_bound_ms_R{R}"] = b["bound_ms"]
        extra[f"full_index_bound_by_R{R}"] = b["bound_by"]
        extra[f"full_index_GBps_R{R}"] = index_bytes / full_ms / 1e6
        extra[f"full_index_share_of_bound_R{R}"] = b["bound_ms"] / full_ms
        zb = bound(nbytes(db_slice, q_slice, got),
                   2 * nbytes(db_slice) * 4 * R, INT8_OPS_PER_S)
        extra[f"ms_R{R}"] = cuda_ms(
            lambda: sj.firstdim_multiply(params, db_slice, q_slice), 10)
        extra[f"plain_ms_R{R}"] = cuda_ms(
            lambda: sj.firstdim_multiply_plain(params, db_slice, q_slice), 2)
        extra[f"bound_ms_R{R}"] = zb["bound_ms"]
        if R == 2:
            row = dict(ms=extra["ms_R2"], plain_ms=extra["plain_ms_R2"],
                       bnd=zb, library_ms=int_mm_ms(db_slice))
        if R == max(columns):
            wide = dict(R=R, ms=extra[f"ms_R{R}"],
                        plain_ms=extra[f"plain_ms_R{R}"], bnd=zb)
        del q_full, q_slice, got
    extra["library_ms_R32"] = int_mm_ms(db_slice, 32)
    extra["full_index_library_ms_R2"] = int_mm_ms(db, 8)
    extra["full_index_library_ms_R32"] = int_mm_ms(db, 32)
    return {"row": row, "wide": wide, "extra": extra}


def check_expand_round(params, splan, gen, dev, table: KernelTable) -> None:
    """E' against its plain version at the dense expansion's batch sizes
    (1, 64, 512 selected cts; left and right key widths) and at the widest
    round of the S1 sparse schedule; timed at 512."""
    from sdk_tpu_torch.ops import spiral as sj

    plan = sj.ExpansionPlan(params, dev)
    widest = max(max(rd["even_sel"].numel(), rd["odd_sel"].numel())
                 for rd in splan.rounds)
    cases = [(b, t) for b in (1, 64, 512)
             for t in (params.t_exp_left, params.t_exp_right)]
    cases.append((widest, params.t_exp_left))
    for i, (B, t_exp) in enumerate(cases):
        x = residues(params, gen, (B, 2, 1), dev)
        x[0, :, :, :, :16] = 0            # negated zeros: Q, not 0
        tables = plan.auto(i % params.poly_len_log2)
        table.check("expand_round", f"B={B} t_exp={t_exp}", max_abs_err(
            sj.expand_round(params, x, tables, t_exp),
            sj.expand_round_plain(params, x, tables, t_exp)))
    x = residues(params, gen, (512, 2, 1), dev)
    tables = plan.auto(3)
    t_exp = params.t_exp_left
    out_bytes = 4 * (512 * t_exp + 512) * 2 * params.poly_len
    table.timed("expand_round", "sdk_tpu_torch/csrc/expand_round.cu",
                "sdk_tpu/ops/spiral_jax.py:554",
                f"B=512 selected cts, t_exp={t_exp}: (512, 2, 1, 2, 2048) "
                f"int32 -> ({512 * t_exp + 512}, 2, 2048); also checked at "
                f"{[c for c in cases]} (B, t_exp), the last the widest S1 "
                f"sparse round",
                cuda_ms(lambda: sj.expand_round(params, x, tables, t_exp), 20),
                cuda_ms(lambda: sj.expand_round_plain(params, x, tables,
                                                      t_exp), 3),
                bound(nbytes(x, *tables) + out_bytes,
                      30 * x.numel() // 2, INT32_OPS_PER_S))


def expansion_key_sets(params, gen: np.random.Generator, nq: int, dev):
    """nq random key sets, one a query: key dicts of keyed (w, w')
    expansion matrices (left and right, a round each), as pp_to_device
    makes them."""
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    sets = []
    for _ in range(nq):
        d = {}
        for name, t in (("v_exp_left", params.t_exp_left),
                        ("v_exp_right", params.t_exp_right)):
            m = np.stack([gen.integers(0, q, (params.g(), 2, t,
                                              params.poly_len))
                          for q in params.moduli], axis=-2).astype(np.uint64)
            w = u32_bits(m, dev)
            ws = u32_bits(shoup_companion_arr(params, m), dev)
            d[name] = [(w[r], ws[r]) for r in range(params.g())]
        sets.append(d)
    return sets


def expansion_work(params, rnd, nq: int) -> tuple:
    """Bytes and integer operations of kernel E on one round: the parents
    read once, the entries written once, the keys of the sides the round
    uses read once; an updated entry is t_exp + 1 two-channel transforms
    (row 0's inverse and the digits' forward ones) and t_exp x 2 rows x 2
    channels x n multiply-adds."""
    n = params.poly_len
    ct = 2 * 2 * n * 4
    sides = ((rnd.n_left, params.t_exp_left), (rnd.n_right, params.t_exp_right))
    key_bytes = nq * sum(2 * 2 * t * 2 * n * 4 for cnt, t in sides if cnt)
    ops = nq * sum(cnt * (transform_ops(t + 1, params) + t * 2 * 2 * 2 * n)
                   for cnt, t in sides)
    return nq * (rnd.n_in + rnd.n_out) * ct + key_bytes, ops


def expansion_inputs(params, gen, nq: int, dev):
    """NQ random query cts of the first round, with zeros that the first
    round's automorphism negates to Q (row 0 of query 0 all zero; the last
    query's row 1 with 64 zero coefficients)."""
    from sdk_tpu_torch.ops import spiral as sj

    cts = residues(params, gen, (nq, 1, 2, 1), dev)
    cts[0, 0, 0] = 0
    raw = torch.from_numpy(gen.integers(0, params.modulus,
                                        (1, 1, params.poly_len)))
    raw[..., :64] = 0
    cts[-1, 0, 1:2] = sj._to_ntt_plain(params, raw).to(dev)
    return cts


def check_expansion(params, splan, gen, dev, table: KernelTable) -> None:
    """Kernel E against expansion_round_plain on every round of a whole
    dense expansion and of the S1 sparse one, at NQ = 1 and at NQ = 16 with
    16 key sets, each round's input with zeros that negate to Q; every
    round timed beside its bound, the whole dense expansion at NQ = 16 in
    the row's headline (and its plain version's time)."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj

    plan = sj.ExpansionPlan(params, dev)
    right = params.t_gsw * params.db_dim_2
    extra, whole = {}, {}
    for label, sched in (("dense", sj.dense_schedule(params, right, dev)),
                         ("S1", splan.schedule)):
        for nq in (1, 16):
            keys = sj.ExpansionKeys(params, expansion_key_sets(params, gen,
                                                               nq, dev))
            cts = expansion_inputs(params, gen, nq, dev)
            tot = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
            for r, rnd in enumerate(sched):
                if r:       # zeros in this round's parents too
                    cts[0, 0, 0] = 0
                got = sj.expansion_round(params, plan, r, cts, rnd, keys)
                want = sj.expansion_round_plain(params, plan, r, cts, rnd, keys)
                table.check("expansion", f"{label} NQ={nq} round {r}",
                            max_abs_err(got, want))
                del want
                ms = cuda_ms(lambda: sj.expansion_round(params, plan, r, cts,
                                                        rnd, keys), 10)
                work = expansion_work(params, rnd, nq)
                key = f"{label}_nq{nq}_round{r}"
                extra[f"{key}_ms"] = ms
                extra[f"{key}_bound_ms"] = bound(*work, INT32_OPS_PER_S)[
                    "bound_ms"]
                extra[f"{key}_updates"] = nq * rnd.n_update
                tot["ms"] += ms
                tot["bytes"] += work[0]
                tot["ops"] += work[1]
                if label == "dense" and nq == 16:
                    tot["plain_ms"] += cuda_ms(lambda: sj.expansion_round_plain(
                        params, plan, r, cts, rnd, keys), 1)
                    torch.cuda.empty_cache()
                cts = got
            tot.update(bound(tot["bytes"], tot["ops"], INT32_OPS_PER_S))
            whole[(label, nq)] = tot
            extra[f"{label}_nq{nq}_whole_ms"] = tot["ms"]
            extra[f"{label}_nq{nq}_whole_bound_ms"] = tot["bound_ms"]
            del cts, keys
            torch.cuda.empty_cache()
    head = whole[("dense", 16)]
    t_exp = params.t_exp_left
    table.timed("expansion", "sdk_tpu_torch/csrc/expansion.cu",
                "sdk_tpu/ops/spiral_jax.py:554 (driven by :577 and :750)",
                f"a whole dense expansion of 16 queries with their own keys: "
                f"{params.g()} rounds, (16, 2^r, 2, 1, 2, {params.poly_len}) "
                f"int32 -> (16, 2^(r+1), ...), t_exp {t_exp}; every round "
                f"and the S1 sparse schedule, NQ = 1 and 16, in the other "
                f"keys", head["ms"], head["plain_ms"],
                {k: head[k] for k in ("bound_ms", "bound_by")}, None, **extra,
                blocks_per_sm=_build.lib()["sdk_expansion_occupancy"](),
                ptxas=_build.ptxas_usage("expansion"),
                tilings={f"round{r}_nq{nq}": sj.expansion_tiling(
                    nq * rnd.n_update, t_exp).cluster
                    for nq in (1, 16) for r, rnd in enumerate(
                        sj.dense_schedule(params, right, dev))})
    log(f"[lifecycle] E equals its plain version on every round of the dense "
        f"and the S1 sparse expansion, NQ = 1 and 16 (16 key sets); whole "
        f"dense expansion NQ=1 {whole[('dense', 1)]['ms']:.4f} ms, NQ=16 "
        f"{head['ms']:.4f} ms (bound {head['bound_ms']:.4f} ms); S1 NQ=16 "
        f"{whole[('S1', 16)]['ms']:.4f} ms")


def phase_lifecycle(params, sessions: Sessions, dev, table: KernelTable,
                    launches: Launches, s1_keys: int = 100,
                    s2_items: int = 3500, s3_items: int = 4200,
                    batches: int = 1) -> dict:
    """A fresh 1 GiB bucket through S1, S2 and S3 (phase 5), each state
    read by 3 single reads and ``batches`` 16-query batches."""
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    n_items = params.num_items()
    gen = np.random.default_rng(SEED + 3)
    torch.cuda.reset_peak_memory_stats(dev)
    srv = SpiralKvServerTorch(params)            # the default device: cuda
    if srv.device.type != dev.type:
        raise AssertionError(f"default device is {srv.device}")
    db = srv.engine.db
    compact_bytes = nbytes(db.planes)
    # 2 channels x 2048 z x 4 limbs x 16 (instance, trial) x 64 bins x 8
    # slots = 134,217,728 bytes at the 1 GiB bucket
    want = int(np.prod(sj.compact_shape(params, 8)))
    if not isinstance(db, sj.CompactDb) or db.cap_bin != 8 \
            or compact_bytes != want:
        raise AssertionError(f"a new bucket must hold a cap-8 compact index "
                             f"of {want} bytes, got {compact_bytes}")
    out = {"new_bucket": {"compact_bytes": compact_bytes,
                          "memory_allocated": torch.cuda.memory_allocated(dev)}}
    log(f"[lifecycle] new 1 GiB bucket: compact index, cap 8, "
        f"{compact_bytes} bytes of planes; memory_allocated "
        f"{out['new_bucket']['memory_allocated']}")
    uids = sessions.setup(srv)

    # S1: ~100 keys, compact, sparse expansion
    keys = distinct_row_keys(n_items, s1_keys)
    values = {k: bytes(gen.integers(0, 256, value_len(params), dtype=np.uint8))
              for k in keys}
    write_values(srv, values)
    srv.flush()
    if srv.engine._splan is None or not isinstance(srv.engine.db, sj.CompactDb):
        raise AssertionError("S1: want a compact index with sparse expansion")
    splan = srv.engine._splan
    s1, counts = launches.run(lambda: sessions.drive(
        srv, uids, keys, values, 0, 3, batches))
    if min(counts["scan_compact"], counts["expansion"]) <= 0:
        raise AssertionError(f"S1 reads did not launch I and E: {counts}")
    s1.update(populated_items=len(srv._populated_items),
              populated_dim0_rows=len(splan.populated),
              layout=srv.meta()["index_layout"], launches=counts)
    out["S1"] = s1
    log(f"[lifecycle] S1: {len(keys)} keys, {len(splan.populated)} of "
        f"{1 << params.db_dim_1} first-dim rows; compact + sparse expansion; 3 reads + 1 batch "
        f"decoded; single median {s1['single_read_ms_median']:.2f} ms, batch "
        f"{s1['batch16_ms_median']:.2f} ms")
    cs1 = check_compact_scan(params, srv.engine.db, gen, table, "S1")
    out["compact_scan_S1"] = cs1["extra"]
    log(f"[lifecycle] I equals its plain version on the S1 index (cap "
        f"{cs1['extra']['cap_bin']}, R=2, 32); whole index R=2 "
        f"{cs1['extra']['full_index_ms_R2']:.4f} ms, R=32 "
        f"{cs1['extra']['full_index_ms_R32']:.4f} ms")

    # S2: ~3,500 items, compact, dense expansion
    taken = set(srv._populated_items)
    free = np.array(sorted(set(range(n_items)) - taken))
    extra_items = gen.choice(free, s2_items - len(taken), replace=False)
    for i, data in random_rows(params, gen, sorted(extra_items)).items():
        srv.update_item_raw(int(i), data)
    srv.flush()
    db = srv.engine.db
    if not isinstance(db, sj.CompactDb) or srv.engine._splan is not None:
        raise AssertionError("S2: want a compact index, dense expansion")
    s2, counts = launches.run(lambda: sessions.drive(
        srv, uids, keys, values, 64, 3, batches))
    s2.update(populated_items=len(srv._populated_items), cap_bin=db.cap_bin,
              compact_bytes=nbytes(db.planes),
              layout=srv.meta()["index_layout"], launches=counts)
    out["S2"] = s2
    log(f"[lifecycle] S2: {len(srv._populated_items)} items "
        f"({len(srv._populated_items) / n_items:.1%}); compact, cap_bin "
        f"{db.cap_bin} ({s2['compact_bytes']} bytes), dense expansion; reads "
        f"+ batch decoded; single median {s2['single_read_ms_median']:.2f} "
        f"ms, batch {s2['batch16_ms_median']:.2f} ms")
    cs2 = check_compact_scan(params, db, gen, table, "S2")
    out["compact_scan"] = cs2["extra"]
    row = cs2["row"]
    table.timed("scan_compact", "sdk_tpu_torch/csrc/scan_compact.cu",
                "sdk_tpu/ops/spiral_jax.py:291",
                f"z-slice 64 of {params.poly_len} of the S2 compact index "
                f"(cap {db.cap_bin}), R=2; the whole index in full_index_*; "
                f"the S1 index (cap {cs1['extra']['cap_bin']}) in S1_*; "
                f"library_ms: torch._int_mm over the same int8 bytes x 8 "
                f"int8 columns, *library_ms_R32 x 32 columns (no mod-q "
                f"recombination)",
                row["ms"], row["plain_ms"], row["bnd"], row["library_ms"],
                **cs2["extra"],
                **{f"S1_{k}": v for k, v in cs1["extra"].items()},
                ptxas=ptxas_forms("scan_compact", ("ntw", "sw")))
    log(f"[lifecycle] I equals its plain version on the S2 index (R=2, 32); "
        f"whole index R=2 {cs2['extra']['full_index_ms_R2']:.4f} ms, R=32 "
        f"{cs2['extra']['full_index_ms_R32']:.4f} ms (torch._int_mm x 32 "
        f"columns {cs2['extra']['full_index_library_ms_R32']} ms)")
    check_expand_round(params, splan, gen, dev, table)
    log("[lifecycle] E' (off the read path since E) equals its plain version "
        "(B = 1, 64, 512, left and right keys, the widest S1 sparse round)")
    check_expansion(params, splan, gen, dev, table)
    out["compact_to_dense"] = check_compact_to_dense(
        params, db, srv._updates.slots.bin_count, table)
    log(f"[lifecycle] H' equals its plain version on the S2 index; "
        f"{out['compact_to_dense']['ms']:.3f} ms against its plain "
        f"version's {out['compact_to_dense']['plain_ms']:.3f} ms")
    del db

    # S3: past 4,096 items: the next flush migrates to the dense index
    taken = set(srv._populated_items)
    free = np.array(sorted(set(range(n_items)) - taken))
    more = gen.choice(free, s3_items - len(taken), replace=False)
    for i, data in random_rows(params, gen, sorted(more)).items():
        srv.update_item_raw(int(i), data)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    _, mig_counts = launches.run(srv.flush)
    migrate_s = time.perf_counter() - t
    if isinstance(srv.engine.db, sj.CompactDb) \
            or mig_counts["compact_to_dense"] != 1:
        raise AssertionError(f"S3: the bucket did not migrate to dense "
                             f"through H': {mig_counts}")
    peak = torch.cuda.max_memory_allocated(dev)
    s3, counts = launches.run(lambda: sessions.drive(
        srv, uids, keys, values, 128, 3, batches))
    if counts["scan"] <= 0 or counts["scan_compact"] != 0:
        raise AssertionError(f"S3 reads did not scan the dense index: {counts}")
    s3.update(populated_items=len(srv._populated_items),
              layout=srv.meta()["index_layout"], flush_with_migration_s=migrate_s,
              migration_peak_memory=peak, launches=counts)
    out["S3"] = s3
    log(f"[lifecycle] S3: {len(srv._populated_items)} items; migrated to "
        f"dense in a {migrate_s:.2f} s flush, peak memory {peak}; reads + "
        f"batch decoded; single median {s3['single_read_ms_median']:.2f} ms, "
        f"batch {s3['batch16_ms_median']:.2f} ms")
    c = check_dense_scan(params, srv.engine.db, gen, table, "migrated index")
    out["migrated_scan"] = c["extra"]
    log("[lifecycle] C equals its plain version on the migrated index")
    del srv, c
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_full(params, sessions: Sessions, dev, table: KernelTable,
               launches: Launches) -> dict:
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    out = {"params": {"nu_1": params.db_dim_1, "nu_2": params.db_dim_2,
                      "instances": params.instances,
                      "version": params.version},
           "index_bytes": int(np.prod(sj.db_shape(params)))}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = SpiralKvServerTorch(params, device=dev)
    n_items = params.num_items()
    gen = np.random.default_rng(SEED + 1)
    step = n_items // 8         # 4096: the first flush stays compact (cap 64)
    layouts = []

    def fill():
        for s in range(0, n_items, step):
            for i, data in random_rows(params, gen, range(s, s + step)).items():
                srv.update_item_raw(i, data)
            srv.flush()
            db = srv.engine.db
            layouts.append(f"compact cap {db.cap_bin}"
                           if isinstance(db, sj.CompactDb) else "dense")

    _, fill_counts = launches.run(fill)
    out["fill_s"] = time.perf_counter() - t0
    out["fill_launches"] = {k: v for k, v in fill_counts.items() if v}
    out["layouts_after_each_flush"] = layouts
    if not layouts[0].startswith("compact") or layouts[1] != "dense" \
            or fill_counts["compact_to_dense"] != 1:
        raise AssertionError(f"fill: want compact then dense through H', "
                             f"got {layouts[:2]}, {fill_counts}")
    log(f"[full] filled {n_items} items through the device ingest in "
        f"{out['fill_s']:.1f} s; after each flush: {layouts[0]}, then "
        f"{layouts[1]} (migrated)")

    values = {k: bytes(gen.integers(0, 256, value_len(params), dtype=np.uint8))
              for k in KEYS}
    write_values(srv, values)
    srv.flush()

    c = check_dense_scan(params, srv.engine.db, gen, table, "full index",
                         (2, 32, 128))
    db = srv.engine.db
    M = int(np.prod(db.shape[4:7]))
    tilings = {f"R{R}": sj.scan_tiling(R, M, db.shape[1], db.shape[3])._asdict()
               for R in (2, 32, 128)}
    table.timed("scan", "sdk_tpu_torch/csrc/scan.cu",
                "sdk_tpu/ops/spiral_jax.py:430",
                f"z-slice 64 of {params.poly_len} of the filled index, R=2 "
                f"(ms, plain_ms, bound_ms, library_ms); R=32 and the whole "
                f"index in *_R*; library_ms and full_index_library_ms_R2: "
                f"torch._int_mm over the same int8 bytes x 8 int8 columns, "
                f"*library_ms_R32 x 32 columns (no mod-q recombination)",
                c["row"]["ms"], c["row"]["plain_ms"], c["row"]["bnd"],
                c["row"]["library_ms"], **c["extra"], tilings=tilings,
                ptxas=ptxas_forms("scan", ("ntw",)))
    log(f"[full] scan (int8 mma.sync) equals its plain version on the "
        f"filled index (R=2, R=32); whole index R=2 "
        f"{c['extra']['full_index_ms_R2']:.4f} ms, R=32 "
        f"{c['extra']['full_index_ms_R32']:.4f} ms "
        f"({c['extra']['full_index_share_of_bound_R32']:.0%} of its bound; "
        f"torch._int_mm x 32 columns "
        f"{c['extra']['full_index_library_ms_R32']} ms)")
    w = c["wide"]
    table.timed("scan_resident", "sdk_tpu_torch/csrc/scan.cu",
                "sdk_tpu/ops/spiral_jax.py:430",
                f"z-slice 64 of {params.poly_len} of the filled index, "
                f"R={w['R']} (a 48-query dispatch's 64 padded queries); the "
                f"whole index in the scan row's *_R{w['R']}",
                w["ms"], w["plain_ms"], w["bnd"], None)
    wide_ms = c["extra"][f"full_index_ms_R{w['R']}"]
    log(f"[full] scan's resident form equals its plain version on the "
        f"filled index (R={w['R']}); whole index {wide_ms:.4f} ms")
    del c, db

    uids = sessions.setup(srv)
    reads, counts = launches.run(lambda: sessions.drive(
        srv, uids, list(KEYS), values, 192, 5, 2))
    out.update(reads, launches=counts,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               recall_at_1=1.0)
    log(f"[full] 5 single reads through private_read and 2 x 16-query "
        f"batches decoded; single median {reads['single_read_ms_median']:.2f} "
        f"ms, batch {reads['batch16_ms_median']:.2f} ms")
    # the benchmark's dispatch: 48 queries (6 requests of 8 rows), padded to
    # 64, a scan of R = 128 columns in the resident form
    wide = [sessions.blob(uids, 1 + i % 4, KEYS[i % 3], 300 + i)
            for i in range(48)]
    resps, wide_counts = launches.run(
        lambda: srv.dispatch_read_blobs(wide)())
    for i, resp in enumerate(resps):
        check_value(sessions.clients[1 + i % 4], resp, KEYS[i % 3],
                    values[KEYS[i % 3]])
    if wide_counts.get("scan_resident") != 1 or wide_counts.get("scan"):
        raise AssertionError(f"a 48-query dispatch: launches {wide_counts}, "
                             f"want one scan_resident and no scan")
    out["launches_48"] = wide_counts
    log(f"[full] a 48-query dispatch decoded; its scan in the resident form "
        f"({wide_counts['scan_resident']} launch)")
    probe = {"uids": uids, "single_blob": sessions.blob(uids, 0, KEYS[0], 250),
             "batch_blobs": [sessions.blob(uids, 1 + i // 4, KEYS[i % 3],
                                           260 + i) for i in range(16)]}
    out["stages_ms"] = stage_breakdown(srv, [probe["single_blob"]])
    out["stages_ms_batch16"] = stage_breakdown(srv, probe["batch_blobs"])
    log(f"[full] 16-batch stages {out['stages_ms_batch16']} ms; scan stage "
        f"{out['stages_ms_batch16']['scan']:.2f} ms (52.03 ms with the dp4a "
        f"scan, PERF.md section 5)")
    probe.update(probe_reads(srv, probe, sessions, values))
    out["probe"] = {k: v for k, v in probe.items() if k.endswith("_ms")}
    # the bucket stays for phase_sharded's paired timing (two 8.59 GB
    # indexes fit on the card); phase_sharded drops it
    probe["srv"] = srv
    return out, probe


def probe_reads(srv, probe: dict, sessions: Sessions, values: dict) -> dict:
    """The probe blobs through ``srv``: three single reads and two 16-query
    batches, every response decoded; the responses and median wall ms."""
    lat, bt = [], []
    for _ in range(3):
        t = time.perf_counter()
        single = srv.private_read_blobs([probe["single_blob"]])[0]
        lat.append((time.perf_counter() - t) * 1e3)
    for _ in range(2):
        t = time.perf_counter()
        batch = srv.dispatch_read_blobs(probe["batch_blobs"])()
        bt.append((time.perf_counter() - t) * 1e3)
    check_value(sessions.clients[0], single, KEYS[0], values[KEYS[0]])
    for i, resp in enumerate(batch):
        check_value(sessions.clients[1 + i // 4], resp, KEYS[i % 3],
                    values[KEYS[i % 3]])
    return {"single": single, "batch": batch,
            "single_read_ms": float(np.median(lat)),
            "batch16_ms": float(np.median(bt))}


def paired_read_ms(buckets: dict, probe: dict, rounds: int = 6) -> dict:
    """The probe's single read and 16-batch on each of two buckets in
    alternation (a b, b a, ...), so that both see the same stretch of this
    run's host: the median wall ms of each, and every sample."""
    names = list(buckets)
    samples = {f"{n}_{kind}": [] for n in names for kind in ("single", "batch16")}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            t = time.perf_counter()
            buckets[n].private_read_blobs([probe["single_blob"]])
            samples[f"{n}_single"].append((time.perf_counter() - t) * 1e3)
        for n in (names if r % 2 == 0 else names[::-1]):
            t = time.perf_counter()
            buckets[n].dispatch_read_blobs(probe["batch_blobs"])()
            samples[f"{n}_batch16"].append((time.perf_counter() - t) * 1e3)
    return {**{f"{k}_ms": float(np.median(v)) for k, v in samples.items()},
            "samples_ms": samples}


def check_compact_to_dense(params, db, counts, table: KernelTable) -> dict:
    """Kernel H' against its plain version (a scatter-add by index_put_ per
    (channel, limb) plane) on a compact index, exactly, and both timed. No
    one PyTorch call computes the migration: its library column is empty."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.kv.ingest import (compact_to_dense,
                                         compact_to_dense_plain,
                                         migrate_tiling)
    from sdk_tpu_torch.ops.spiral import db_shape

    got = compact_to_dense(params, db, counts)
    want = compact_to_dense_plain(params, db, counts)
    table.check("compact_to_dense", f"S2 index, cap {db.cap_bin}",
                max_abs_err_int8(got, want))
    dense_bytes = nbytes(got)
    del got, want
    ms = cuda_ms(lambda: compact_to_dense(params, db, counts), 3)
    plain_ms = cuda_ms(lambda: compact_to_dense_plain(params, db, counts), 1)
    occupied = int(np.minimum(counts, db.cap_bin).sum())
    crt, z, L, cw, inst, trials, npr, _ = db.planes.shape
    # this run's data: the occupied slots' limbs read once, every byte of
    # the dense index written once
    b = bound(dense_bytes + occupied * crt * z * L * inst * trials
              + nbytes(db.idx_j) + 4 * len(counts), 0, INT32_OPS_PER_S)
    tl = migrate_tiling(cw, db_shape(params)[3], inst * trials, npr,
                        int(np.max(counts)))
    # analytic, not measured: the slot words up to the fullest bin, which
    # the kernel stages
    staged = crt * z * L * tl.cw_used * 4 * inst * trials * npr
    table.timed("compact_to_dense", "sdk_tpu_torch/csrc/compact_to_dense.cu",
                "sdk_tpu/kv/ingest.py:161",
                f"the S2 compact index (cap {db.cap_bin}, {occupied} occupied "
                f"slots, {nbytes(db.planes)} bytes of planes) -> a new dense "
                f"index of {dense_bytes} bytes; bound_ms counts the occupied "
                f"slots' bytes, the kernel reads every slot word up to the "
                f"fullest bin; plain_ms: the plain version, "
                f"index_put_(accumulate=True) per (channel, limb) plane",
                ms, plain_ms, b, None, occupied_slots=occupied,
                dense_GBps=dense_bytes / ms / 1e6,
                ptxas=_build.ptxas_usage("compact_to_dense"))
    log(f"[kernels] H' configuration: tile {tl._asdict()}; analytic staged "
        f"plane bytes (slot words up to the fullest bin) {staged}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "occupied_slots": occupied}


def check_psum_mod(params, dev, table: KernelTable) -> dict:
    """Kernel M against its plain version at the 1 GiB bucket's partial
    shapes, D = 2, 4, 8, in the Spiral form (residues below q_c) and the
    wrapping form (any 32 bits, q = 0), exactly; timed beside its plain
    version and the library's torch.stack(parts).sum(0) % q. The row's
    main numbers are the main path's: D = 4 partials of a (dp=2, db=4)
    mesh, (2, z, inst, trials / 2, num_per, 2) for a single read."""
    from sdk_tpu_torch.ops.shard import psum_mod, psum_mod_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    z, inst, npr = params.poly_len, params.instances, 1 << params.db_dim_2
    trials = params.n * params.n
    qcol = torch.tensor(params.moduli, dtype=torch.int64,
                        device=dev).reshape(2, 1, 1, 1, 1, 1)

    def parts(D, tl, R, form):
        shape = (2, z, inst, tl, npr, R)
        if form == "spiral":
            return [torch.randint(0, min(params.moduli), shape, generator=gen,
                                  dtype=torch.int32, device=dev)
                    for _ in range(D)]
        return [torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                              dtype=torch.int32, device=dev)
                for _ in range(D)]

    def case(D, tl, R, form) -> dict:
        ps = parts(D, tl, R, form)
        q = params.moduli if form == "spiral" else 0
        table.check("psum_mod", f"D={D} {form} {tuple(ps[0].shape)}",
                    max_abs_err(psum_mod(ps, q), psum_mod_plain(ps, q)))
        if form == "spiral":
            lib = lambda: torch.stack(ps).sum(0) % qcol
        else:
            lib = lambda: torch.stack(ps).sum(0) & 0xFFFFFFFF
        r = {"ms": cuda_ms(lambda: psum_mod(ps, q), 20),
             "plain_ms": cuda_ms(lambda: psum_mod_plain(ps, q), 3),
             "library_ms": cuda_ms(lib, 5),
             "bnd": bound((D + 1) * nbytes(ps[0]), D * ps[0].numel(),
                          INT32_OPS_PER_S),
             "part_bytes": nbytes(ps[0])}
        return r

    extra = {}
    for D in (2, 4, 8):
        for form in ("spiral", "wrapping"):
            r = case(D, trials, 2, form)
            for k in ("ms", "plain_ms", "library_ms"):
                extra[f"D{D}_{form}_{k}"] = r[k]
            extra[f"D{D}_{form}_bound_ms"] = r["bnd"]["bound_ms"]
    main = case(4, trials // 2, 2, "spiral")
    batch = case(4, trials // 2, 32, "spiral")
    extra.update(R32_ms=batch["ms"], R32_plain_ms=batch["plain_ms"],
                 R32_library_ms=batch["library_ms"],
                 R32_bound_ms=batch["bnd"]["bound_ms"],
                 part_bytes=main["part_bytes"])
    table.timed("psum_mod", "sdk_tpu_torch/csrc/psum_mod.cu",
                "sdk_tpu/ops/shard.py:42",
                f"D=4 int32 partials (2, {z}, {inst}, {trials // 2}, {npr}, "
                f"2) of a (dp=2, db=4) mesh, mod q_c per channel (a single "
                f"read); R=32 (a 16-batch) in R32_*; D=2/4/8 x (2, {z}, "
                f"{inst}, {trials}, {npr}, 2) in the Spiral and the wrapping "
                f"(q = 0) forms in D*_; library_ms: torch.stack(parts)"
                f".sum(0) % q", main["ms"], main["plain_ms"], main["bnd"],
                library_ms=main["library_ms"], **extra)
    return {"ms": main["ms"], "bound_ms": main["bnd"]["bound_ms"]}


def phase_sharded(params, sessions: Sessions, dev, table: KernelTable,
                  launches: Launches, probe: dict) -> dict:
    """The full bucket's rows in a bucket cut over eight logical shards of
    the card; its responses to phase_full's probe blobs are the unsharded
    bucket's bytes, and both buckets are timed in alternation."""
    from sdk_tpu_torch.ops.shard import make_mesh
    from sdk_tpu_torch.selfcheck import (sharded_doublepir_check,
                                         sharded_protocol_check)
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    mesh = make_mesh(8, dp=2, devices=[dev] * 8)
    torch.cuda.reset_peak_memory_stats(dev)
    srv = SpiralKvServerTorch(params, mesh=mesh)
    db = srv.engine.db
    out = {"mesh": mesh.shape, "devices": [str(d) for d in mesh.devices.flat],
           "shard_shape": list(db.shards[0][0].shape),
           "logical_shards_of_one_card": True}
    log(f"[sharded] a (dp=2, db=4) mesh of eight logical shards of "
        f"{dev} (one card): shard shape {out['shard_shape']}")
    n_items = params.num_items()
    gen = np.random.default_rng(SEED + 1)      # phase_full's rows, again
    step = n_items // 8

    def fill():
        for s0 in range(0, n_items, step):
            for i, data in random_rows(params, gen, range(s0, s0 + step)).items():
                srv.update_item_raw(i, data)
            srv.flush()

    t0 = time.perf_counter()
    _, fill_counts = launches.run(fill)
    out["fill_s"] = time.perf_counter() - t0
    out["fill_launches"] = {k: v for k, v in fill_counts.items() if v}
    values = {k: bytes(gen.integers(0, 256, value_len(params), dtype=np.uint8))
              for k in KEYS}
    write_values(srv, values)
    srv.flush()
    for uid, pp in zip(probe["uids"], sessions.pp):
        srv.setup_raw(pp, uid)
    got, counts = launches.run(lambda: probe_reads(srv, probe, sessions,
                                                   values))
    if got["single"] != probe["single"] or got["batch"] != probe["batch"]:
        raise AssertionError("sharded responses differ from the unsharded "
                             "full bucket's")
    if min(counts["psum_mod"], counts["scan"], counts["fold_round"]) <= 0:
        raise AssertionError(f"sharded reads did not launch C, M, F: {counts}")
    paired = paired_read_ms({"sharded": srv, "unsharded": probe["srv"]},
                            probe)
    out.update(single_read_ms=paired["sharded_single_ms"],
               batch16_ms=paired["sharded_batch16_ms"],
               unsharded_single_read_ms=paired["unsharded_single_ms"],
               unsharded_batch16_ms=paired["unsharded_batch16_ms"],
               paired_samples_ms=paired["samples_ms"], launches=counts,
               max_memory_allocated_beside_the_unsharded_bucket=
               torch.cuda.max_memory_allocated(dev))
    log(f"[sharded] filled {n_items} items in {out['fill_s']:.1f} s; the "
        f"probe blobs' single read and 16-batch equal the unsharded "
        f"bucket's bytes and decode; in alternation with the unsharded "
        f"bucket (medians of 6): single {out['single_read_ms']:.2f} ms "
        f"(unsharded {out['unsharded_single_read_ms']:.2f}), batch "
        f"{out['batch16_ms']:.2f} ms (unsharded "
        f"{out['unsharded_batch16_ms']:.2f})")
    del srv, db
    probe.pop("srv")
    gc.collect()
    torch.cuda.empty_cache()
    out["psum_mod"] = check_psum_mod(params, dev, table)
    log(f"[sharded] M equals its plain version (D = 2, 4, 8, both forms); "
        f"main path shape {out['psum_mod']['ms']:.4f} ms")
    _, counts = launches.run(lambda: (
        sharded_protocol_check(make_mesh(8, dp=2, devices=[dev] * 8)),
        sharded_doublepir_check(make_mesh(4, devices=[dev] * 4))))
    out["selfcheck_launches"] = {k: v for k, v in counts.items() if v}
    log("[sharded] selfchecks: sharded Spiral (dp=2, db=4) and checklist "
        "(db=4) equal unsharded serving and decode")
    out["dcn"] = phase_dcn(dev, launches)
    out["checklist"] = phase_sharded_checklist(dev, launches)
    return out


def phase_dcn(dev, launches: Launches) -> dict:
    """A DCN front end over two port backends of one instance each (on the
    card, behind the port's HTTP service on threads) at V1_SMALL, driven
    through the clients, against one port server with both instances."""
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.clients.api import API
    from sdk_tpu_torch.kv.key_value import row_from_key
    from sdk_tpu_torch.params import params_from_json, params_from_json_obj
    from sdk_tpu_torch.rng import ChaCha20Rng
    from sdk_tpu_torch.server import http as http_t
    from sdk_tpu_torch.server.dcn import (DcnFrontend, backend_params_obj,
                                          serve as dcn_serve)
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    params = params_from_json(V1_SMALL)
    b_params = params_from_json_obj(backend_params_obj(params, 2))
    httpds = []
    try:
        urls = []
        for _ in range(2):
            h = http_t.serve(SpiralKvServerTorch(b_params, dev), 0,
                             block=False)
            httpds.append(h)
            urls.append(f"http://localhost:{h.server_address[1]}")
        fe = dcn_serve(DcnFrontend(params, urls, V1_SMALL), 0, block=False)
        httpds.append(fe)
        one = http_t.serve(SpiralKvServerTorch(params, dev, V1_SMALL), 0,
                           block=False)
        httpds.append(one)
        apis = [API("", f"http://localhost:{h.server_address[1]}")
                for h in (fe, one)]
        gen = np.random.default_rng(SEED + 9)
        values = {f"dcn-{i}": bytes(gen.integers(0, 256, 700, dtype=np.uint8))
                  for i in range(6)}
        kv = {k: base64.b64encode(v).decode() for k, v in values.items()}
        client = Client(params)
        setup = client.generate_keys_from_seed(
            b"\x51" * 32, noise_rng=ChaCha20Rng(b"\x52" * 32),
            pp_seed=b"\x53" * 32).serialize(params)
        uid = "5" * 36
        keys = ["dcn-1", "dcn-4"]
        queries = [uid.encode() + client.generate_query(
            row_from_key(params.num_items(), k),
            noise_rng=ChaCha20Rng(bytes([0x54 + i]) * 32),
            query_seed=bytes([0x58 + i]) * 32).serialize(params)
            for i, k in enumerate(keys)]
        for api in apis:
            api.write("", kv)
            api._post(api.endpoint + f"/setup?uuid={uid}", json.dumps(
                base64.b64encode(setup).decode()).encode(), compress=False)
        got, counts = launches.run(
            lambda: [api.private_read("", queries) for api in apis])
        if got[0] != got[1]:
            raise AssertionError("DCN responses differ from one port "
                                 "server's")
        for k, resp in zip(keys, got[0]):
            check_value(client, resp, k, values[k])
    finally:
        for h in httpds:
            h.shutdown()
    log("[dcn] a front end over two port backends (one instance each) at "
        "V1_SMALL answers with one port server's bytes; responses decode")
    return {"responses": len(got[0]), "bytes": len(got[0][0]),
            "launches": {k: v for k, v in counts.items() if v}}


def phase_sharded_checklist(dev, launches: Launches) -> dict:
    """The row-sharded checklist over four logical shards of the card at a
    small byte-element config against the unsharded one: the hint and
    every answer word of an 8-query batch; the planted bits recover."""
    from sdk_tpu_torch.doublepir import scheme
    from sdk_tpu_torch.doublepir.params import Params
    from sdk_tpu_torch.doublepir.server_torch import ChecklistServerTorch
    from sdk_tpu_torch.ops.shard import make_mesh

    config = "1024,6.4,46,46,32,464"
    params = Params.from_string(config)
    num_entries = params.l * params.m * 8
    gen = np.random.default_rng(SEED + 11)
    bits = gen.integers(0, 256, num_entries // 8, dtype=np.uint16) \
        .astype(np.uint8)
    one = ChecklistServerTorch(num_entries, params, bits, device=dev)
    sh = ChecklistServerTorch(num_entries, params, bits,
                              mesh=make_mesh(4, devices=[dev] * 4))
    shared = scheme.init(one.info, params)
    hint = one.setup(shared)
    hint_sh, setup_counts = launches.run(lambda: sh.setup(shared))
    if not np.array_equal(hint[0], hint_sh[0]):
        raise AssertionError("sharded checklist hint differs")
    all_bits = np.unpackbits(bits, bitorder="little")
    # query k reads row batch k: a target in each batch's rows
    bs = params.l // 8
    targets = [(((k * bs + int(gen.integers(0, bs))) * params.m
                 + int(gen.integers(0, params.m))) * 8
                + int(gen.integers(0, 8))) for k in range(8)]
    states, queries = [], []
    for t in targets:
        st, msg = scheme.query(t, shared, params, one.info, gen)
        states.append(st)
        queries.append(msg)
    want = one.answer(queries)
    got, counts = launches.run(lambda: sh.answer(queries))
    if len(got) != len(want) or not all(
            np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("sharded checklist answer differs")
    for k, t in enumerate(targets):
        if scheme.recover(t, k, hint_sh, queries[k], got, shared, states[k],
                          params, sh.info) != int(all_bits[t]):
            raise AssertionError(f"sharded checklist: bit {t} did not recover")
    if counts["psum_mod"] != 3 or setup_counts["psum_mod"] != 1:
        raise AssertionError(f"sharded checklist sums: {counts}")
    log(f"[sharded checklist] {config} over 4 logical shards (l_pad "
        f"{sh.l_pad}): hint and every answer word equal the unsharded "
        f"server's; 8 planted bits recover")
    return {"config": config, "l_pad": sh.l_pad,
            "answer_launches": {k: v for k, v in counts.items() if v}}


def stage_breakdown(srv, blobs: list) -> dict:
    """Median wall ms of each stage of one dispatch of ``blobs`` (a single
    read, or a batch: the expansion, then one scan, one fold and one pack +
    encode for all), synchronised per stage (for the breakdown only; the
    launches are not counted). The expand stage ends with the batch's scan
    columns and folding keys, and their negations where the engine's
    expand_queries returns them (else the fold stage makes them with
    get_v_folding_neg, as the engine did before the regev_to_gsw kernel):
    the engine's expand_queries where it has one, else (a checkout from
    before it) one expand_query per query and the stack of their columns
    and keys."""
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.shard import fold_columns

    eng = srv.engine
    parsed = [srv._parse_request(b) for b in blobs]
    nq = len(parsed)
    times: dict[str, list] = {"expand": [], "scan": [], "fold": [],
                              "pack_encode": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v_neg = None
        if hasattr(eng, "expand_queries"):
            got = eng.expand_queries([pp for pp, _ in parsed],
                                     [q for _, q in parsed])
            q_all, v_folds = got[:2]
            if len(got) > 2:
                v_neg = got[2]
        else:
            expanded = [eng.expand_query(pp, q) for pp, q in parsed]
            q_all = torch.stack([q for q, _ in expanded], dim=-2)
            q_all = q_all.reshape(q_all.shape[:3] + (2 * nq,))
            v_folds = torch.stack([v for _, v in expanded])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inter = sj.firstdim_multiply(eng.params, eng.db, q_all)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if v_neg is None:
            v_neg = sj.get_v_folding_neg(eng.params, v_folds, eng.gadget_ntt)
        folded = fold_columns(eng.params,
                              inter.reshape(inter.shape[:-1] + (nq, 2)),
                              v_folds, v_neg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        eng._pack_encode(folded, [pp["v_packing"] for pp, _ in parsed])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(times, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(v * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def timed_s(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def check_expansion_launches(params, single: list, batch: list,
                             n_single: int, n_batch: int) -> None:
    """The expansion's hand launches on the main path (expansion_launches'
    records of the service's n_single reads and n_batch 16-query batches,
    one expansion each): the same for every call, for a read as for a
    16-batch, g launches of E, one of the regev_to_gsw kernel and
    EXPANSION_LAUNCHES in all."""
    if len(single) != n_single or len(batch) != n_batch:
        raise AssertionError(f"expected {n_single} single and {n_batch} "
                             f"batched expansions, got {len(single)} / "
                             f"{len(batch)}")
    first = single[0]
    if any(c != first for c in single + batch) \
            or first.get("expansion") != params.g() \
            or first.get("regev_to_gsw") != 1 \
            or sum(first.values()) != EXPANSION_LAUNCHES:
        raise AssertionError(f"the expansion's launches grow with NQ or are "
                             f"not {EXPANSION_LAUNCHES}: reads {single}, "
                             f"batches {batch}")
    log(f"[service] the expansion's hand launches: {sum(first.values())} for "
        f"a read and for a 16-batch ({first})")


def check_read_launches(per_read: dict, per_batch: dict) -> None:
    """A read and a 16-batch of the service make the same READ_LAUNCHES hand
    launches: one G encodes the whole batch, and D is not launched."""
    if per_read != per_batch or sum(per_read.values()) != READ_LAUNCHES \
            or per_read.get("pack") != 1 or "encode" in per_read \
            or per_read.get("regev_to_gsw") != 1 or "matmul_mod" in per_read:
        raise AssertionError(f"hand launches: a read {per_read}, a 16-batch "
                             f"{per_batch}; want {READ_LAUNCHES} each, one G, "
                             f"one regev_to_gsw, no D and no B")
    log(f"[service] hand launches: {READ_LAUNCHES} for a read and for a "
        f"16-batch ({per_read})")


def dispatch_check(srv, blobs: list, check) -> dict:
    """The two-phase dispatch of a warm 16-batch on the bucket's engine:
    dispatch_queries_batched under torch.cuda.set_sync_debug_mode("error")
    (any synchronizing call raises), its host time beside the batch's
    device time (CUDA events: one recorded before the dispatch, one just
    after it, which must not have completed yet: the dispatch returned
    while the card ran the batch), then the fetch: the same bytes as the
    warm batch, each decoded by check(i, response)."""
    eng = srv.engine
    srv.flush()
    reqs = [srv._parse_request(b) for b in blobs]
    want = eng.dispatch_queries_batched(reqs)()        # warm
    torch.cuda.synchronize()
    start, queued = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fetch = eng.dispatch_queries_batched(reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_ms = (time.perf_counter() - t) * 1e3
    queued.record()
    busy = not queued.query()
    got = fetch()
    out = {"nq": len(blobs), "synchronizing_calls": 0,
           "dispatch_host_ms": host_ms,
           "batch_device_ms": start.elapsed_time(queued),
           "device_busy_after_dispatch": busy,
           "same_bytes_as_warm_batch": got == want}
    for i, r in enumerate(got):
        check(i, r)
    if not (busy and got == want
            and out["dispatch_host_ms"] < out["batch_device_ms"]):
        raise AssertionError(f"the dispatch waited for the card: {out}")
    return out


def phase_service(params, sessions: Sessions, dev, launches: Launches,
                  n_keys: int = 300, n_rows: int = 4200,
                  keep_dense: str | None = None) -> dict:
    """The 1 GiB bucket behind its HTTP service on localhost, driven through
    sdk_tpu_torch.clients only. Every step raises on a wrong answer. With
    ``keep_dense`` the dense checkpoint is saved into that directory and
    kept there (the load phase serves it)."""
    from sdk_tpu_torch.clients.api import API, ApiError
    from sdk_tpu_torch.clients.bloom import BloomFilter
    from sdk_tpu_torch.clients.bucket_service import BucketService
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.server.http import serve
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    gen = np.random.default_rng(SEED + 8)
    n_items = params.num_items()
    torch.cuda.reset_peak_memory_stats(dev)
    srv = SpiralKvServerTorch(params, key_storage_policy="full")
    httpd = serve(srv, 0, block=False, batch_window_ms=BATCH_WINDOW_MS)
    base = f"http://localhost:{httpd.server_address[1]}"
    out: dict = {"batch_window_ms": BATCH_WINDOW_MS}
    try:
        api = API("", base)
        bucket = BucketService("", base).connect()
        if bucket.params.num_items() != n_items:
            raise AssertionError("the client read other params from /meta")

        # sessions: four through the JSON /setup, one through the presigned
        # upload flow; the Bucket client sets its own up at its first read
        uids = [api.setup("", pp) for pp in sessions.pp[:4]]
        uids.append(api.setup_presigned("", sessions.pp[4]))
        if not all(api.check(u) for u in uids) or api.check("0" * 36):
            raise AssertionError("/check disagrees with the sessions set up")

        # /write a few hundred keys, read them back privately
        keys = distinct_row_keys(n_items, n_keys)
        values = {k: bytes(gen.integers(0, 256, 2048, dtype=np.uint8))
                  for k in keys}

        def write_and_read():
            bucket.write(values)
            lat = []
            for k in keys[:5]:
                t = time.perf_counter()
                got = bucket.private_read([k])
                lat.append((time.perf_counter() - t) * 1e3)
                if got != [values[k]]:
                    raise AssertionError(f"private read of {k!r} over HTTP "
                                         f"returned the wrong value")
            if bucket.private_read(["never-written"]) != [None]:
                raise AssertionError("an absent key did not read as absent")
            return lat

        lat, counts = launches.run(write_and_read)
        if min(counts["ingest"], counts["fold_round"], counts["pack"]) <= 0:
            raise AssertionError(f"the service did not run H, F, G: {counts}")
        meta = api.meta()
        out["after_write"] = {
            "keys": n_keys, "layout": meta["index_layout"],
            "sparse_expansion": meta["sparse_expansion"],
            "bucket_client_read_ms_all": lat[1:], "launches": counts}
        log(f"[service] /setup x5 (one presigned), /write of {n_keys} keys, "
            f"6 private reads through the Bucket client decoded; index "
            f"{meta['index_layout']}; client-side read (query + HTTP + decode) "
            f"median {float(np.median(lat[1:])):.2f} ms")

        # single reads and 16 readers at once, over HTTP and in process
        single = [sessions.blob(uids, 4, keys[i], 300 + i) for i in range(5)]
        batch_keys = [keys[(7 * i) % n_keys] for i in range(16)]
        batch = [sessions.blob(uids, i // 4, k, 340 + i)
                 for i, k in enumerate(batch_keys)]

        def http_single():
            lat = []
            for i, b in enumerate(single):
                t = time.perf_counter()
                resp = api.private_read("", [b])[0]
                lat.append((time.perf_counter() - t) * 1e3)
                check_value(sessions.clients[4], resp, keys[i], values[keys[i]])
            return lat

        with expansion_launches() as exp_single:
            http_lat, single_counts = launches.run(http_single)
        per_read = {k: v // len(single) for k, v in single_counts.items() if v}

        def http_16():
            results: dict = {}
            errors: list = []
            gate = threading.Barrier(16)

            def reader(i):
                try:
                    gate.wait()
                    results[i] = api.private_read("", [batch[i]])[0]
                except BaseException as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            threads = [threading.Thread(target=reader, args=(i,))
                       for i in range(16)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = (time.perf_counter() - t) * 1e3
            if errors:
                raise errors[0]
            return wall, [results[i] for i in range(16)]

        stats0 = api._get(base + "/metrics")["read_coalescer"]
        walls = []
        for _ in range(3):
            (wall, resps), batch_counts = launches.run(http_16)
            walls.append(wall)
            for i, (k, r) in enumerate(zip(batch_keys, resps)):
                check_value(sessions.clients[i // 4], r, k, values[k])
        stats = api._get(base + "/metrics")["read_coalescer"]
        if stats["max_batch"] <= 1:
            raise AssertionError(f"16 concurrent readers were not coalesced: "
                                 f"{stats}")
        with expansion_launches() as exp_batch:
            direct, direct_counts = launches.run(lambda: [timed_s(
                lambda: srv.private_read_blobs(batch))[1] * 1e3
                for _ in range(3)])
        check_expansion_launches(params, exp_single, exp_batch, len(single), 3)
        check_read_launches(per_read, {k: v // 3 for k, v in
                                       direct_counts.items() if v})
        direct1 = [timed_s(lambda b=b: srv.private_read_blobs([b]))[1] * 1e3
                   for b in single]
        if srv.private_read_blobs(batch) != resps:
            raise AssertionError("coalesced responses differ from one batch's")
        out["reads_compact"] = {
            "http_single_ms_all": http_lat,
            "http_single_ms_median": float(np.median(http_lat)),
            "http_16_readers_wall_ms_all": walls,
            "http_16_readers_wall_ms_median": float(np.median(walls)),
            "direct_single_ms_median": float(np.median(direct1)),
            "direct_batch16_ms_all": direct,
            "direct_batch16_ms_median": float(np.median(direct)),
            "read_coalescer_before": stats0, "read_coalescer": stats,
            "launches_per_single_read": per_read,
            "launches_last_16_readers": {k: v for k, v in batch_counts.items()
                                         if v},
            "launches_per_batch16": {k: v // 3 for k, v in
                                     direct_counts.items() if v},
            "expansion_launches_per_single_read": exp_single[0],
            "expansion_launches_per_batch16": exp_batch[0],
            "stages_ms_single": stage_breakdown(srv, single[:1]),
            "stages_ms_batch16": stage_breakdown(srv, batch)}
        log(f"[service] single read over HTTP median "
            f"{out['reads_compact']['http_single_ms_median']:.2f} ms, in "
            f"process {out['reads_compact']['direct_single_ms_median']:.2f} ms;"
            f" 16 readers at once {out['reads_compact']['http_16_readers_wall_ms_median']:.2f}"
            f" ms (coalescer {stats}), one 16-batch in process "
            f"{out['reads_compact']['direct_batch16_ms_median']:.2f} ms; "
            f"launches per single read {per_read}")

        # the other routes
        bloom = BloomFilter.from_bytes(base64.b64decode(
            api._get(base + "/bloom")["bloom"]))
        if not all(bloom.lookup(k) for k in keys) or bloom.lookup("absent-key"):
            raise AssertionError("/bloom does not hold the written keys")
        if api._get(base + "/list-keys") != sorted(keys):
            raise AssertionError("/list-keys differs from the written keys")
        if bucket.private_key_intersect([keys[3], "absent-key"]) != [keys[3]]:
            raise AssertionError("private_key_intersect is wrong")
        bucket.rename("smoke-bucket")
        meta = api.meta()
        if meta["name"] != "smoke-bucket" or meta["global_version"] < 1:
            raise AssertionError(f"/meta after /modify: {meta}")

        def checkpoint(label: str, keep: str | None = None) -> dict:
            """save_to_dir, restore into a new bucket, same bytes back; the
            checkpoint stays in ``keep`` when given."""
            probe = batch[:4]
            first = srv.private_read_blobs(probe)
            with contextlib.ExitStack() as stack:
                tmp = keep or stack.enter_context(
                    tempfile.TemporaryDirectory())
                _, save_s = timed_s(lambda: srv.save_to_dir(tmp))
                size = dir_bytes(tmp)
                other = SpiralKvServerTorch(params, key_storage_policy="full")
                _, restore_s = timed_s(lambda: other.restore_from_dir(tmp))
            for uid, pp in zip(uids, sessions.pp):
                other.setup_raw(pp, uid)
            second = other.private_read_blobs(probe)
            same = (second == first
                    and other.meta()["index_layout"] == srv.meta()["index_layout"]
                    and other.list_keys() == srv.list_keys())
            del other
            gc.collect()
            torch.cuda.empty_cache()
            if not same:
                raise AssertionError(f"{label}: the restored bucket answers "
                                     f"with other bytes")
            log(f"[service] {label} checkpoint: {size} bytes saved in "
                f"{save_s:.2f} s, restored in {restore_s:.2f} s; the restored "
                f"bucket's responses equal the first's byte for byte")
            return {"bytes": size, "save_s": save_s, "restore_s": restore_s}

        if meta["index_layout"] != "compact":
            raise AssertionError("the bucket migrated before the compact "
                                 "checkpoint")
        out["checkpoint_compact"] = checkpoint("compact")

        # /update-row past 1/8 of the items: the next flush migrates
        taken = set(srv._populated_items)
        free = np.array(sorted(set(range(n_items)) - taken))
        rows = random_rows(params, gen, sorted(
            gen.choice(free, n_rows - len(taken), replace=False)))
        items = [int(i).to_bytes(4, "big") + data for i, data in rows.items()]

        def update_rows():
            for s0 in range(0, len(items), 256):
                body = b"".join(len(b).to_bytes(4, "big") + b
                                for b in items[s0:s0 + 256])
                r = api._post(base + "/update-row", body, compress=False)
                if r["largest_update"] != len(items[0]):
                    raise AssertionError(f"/update-row: {r}")
            resp = api.private_read("", [single[0]])[0]
            check_value(sessions.clients[4], resp, keys[0], values[keys[0]])

        (_, update_s), counts = launches.run(lambda: timed_s(update_rows))
        if api.meta()["index_layout"] != "dense" or counts["scan"] <= 0 \
                or counts["compact_to_dense"] != 1:
            raise AssertionError(f"the bucket did not migrate to dense "
                                 f"through H': {counts}")
        some = sorted(rows)[17]
        resp = api.private_read("", [uids[4].encode() + sessions.clients[4]
                                     .generate_query(some).serialize(params)])[0]
        if sessions.clients[4].decode_response(resp)[:len(rows[some])] \
                != rows[some]:
            raise AssertionError("a row sent through /update-row reads wrong")
        http_lat_dense = http_single()
        (wall, resps), _ = launches.run(http_16)
        for i, (k, r) in enumerate(zip(batch_keys, resps)):
            check_value(sessions.clients[i // 4], r, k, values[k])
        out["dense"] = {
            "rows_sent": len(items), "update_row_and_migrate_s": update_s,
            "launches": {k: v for k, v in counts.items() if v},
            "http_single_ms_median": float(np.median(http_lat_dense)),
            "http_16_readers_wall_ms": wall,
            "stages_ms_single": stage_breakdown(srv, single[:1]),
            "stages_ms_batch16": stage_breakdown(srv, batch)}
        log(f"[service] /update-row of {len(items)} rows + the migrating "
            f"flush + a read in {update_s:.2f} s; dense: single read over "
            f"HTTP median {out['dense']['http_single_ms_median']:.2f} ms, 16 "
            f"readers {wall:.2f} ms")
        out["dispatch_check"] = dispatch_check(
            srv, batch, lambda i, r: check_value(
                sessions.clients[i // 4], r, batch_keys[i],
                values[batch_keys[i]]))
        log(f"[service] dispatch check, the dense 8.59 GB index: a warm "
            f"16-batch's dispatch_queries_batched made no synchronizing call "
            f"(set_sync_debug_mode error) and returned in "
            f"{out['dispatch_check']['dispatch_host_ms']:.2f} ms of host time "
            f"while the card still ran the batch "
            f"({out['dispatch_check']['batch_device_ms']:.2f} ms); the fetch "
            f"gave the warm batch's bytes, every response decoded")
        out["checkpoint_dense"] = checkpoint("dense", keep_dense)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)

        # /clear: reads decode to absent, compact again, memory released
        before = torch.cuda.memory_allocated(dev)
        bucket.clear_entire_bucket()
        gc.collect()
        after = torch.cuda.memory_allocated(dev)
        meta = api.meta()
        if bucket.private_read([keys[0]]) != [None] \
                or meta["index_layout"] != "compact" \
                or not isinstance(srv.engine.db, sj.CompactDb) \
                or before - after < int(np.prod(sj.db_shape(params))) // 2 \
                or api._get(base + "/list-keys") != []:
            raise AssertionError(f"/clear: meta {meta}, memory {before} -> "
                                 f"{after}")
        out["clear"] = {"memory_allocated_before": before,
                        "memory_allocated_after": after}
        # /destroy: 404 from then on
        bucket.destroy_entire_bucket()
        try:
            api.meta()
        except ApiError as e:
            if e.code != 404 or not srv.destroyed:
                raise
        else:
            raise AssertionError("a destroyed bucket still answers")
        log(f"[service] /clear: reads absent, compact again, memory "
            f"{before} -> {after}; /destroy: 404 after")
    finally:
        httpd.shutdown()
        httpd.server_close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the load phase's closed loops: (clients, with the writer), each
# LOAD_DURATION_S long, against one spawned server
LOAD_RUNS = ((1, False), (4, False), (16, False), (16, True))
LOAD_DURATION_S = 10.0


def phase_load(ckpt: str, card: str) -> dict:
    """tools/load_test_torch.py on the 1 GiB bucket: the tool spawns the
    port's server (python -m sdk_tpu_torch.server.http, on the card) from
    the dense checkpoint of phase_service (the full 8.59 GB index), warmed,
    with the service's coalescing window; then each of LOAD_RUNS is the tool
    in a process of its own against that server (--endpoint), every read
    decode-verified, the writer's flushes racing the reads in the last. The
    server is stopped on every exit path. Fails if a run has an error or no
    read, or if a 16-client run never coalesced: its own batches (the
    difference of /metrics' cumulative read_coalescer counts across the
    run) carry no more requests than there are batches, i.e. max_batch < 2
    in the run."""
    import urllib.request

    root = os.path.dirname(os.path.abspath(__file__))
    tools = os.path.join(root, "tools")
    sys.path.insert(0, tools)
    import load_test_torch as tool

    t = time.perf_counter()
    proc, port = tool.spawn_server(BATCH_WINDOW_MS, cpu=False, warmup=True,
                                   restore=ckpt, store=(15, 32768))
    endpoint = f"http://localhost:{port}"
    out = {"server_start_s": time.perf_counter() - t,
           "batch_window_ms": BATCH_WINDOW_MS, "index": "dense, restored",
           "duration_s": LOAD_DURATION_S, "runs": []}
    log(f"[load] server on the card at {endpoint}: restored, warmed and "
        f"listening in {out['server_start_s']:.1f} s")

    def coalescer() -> dict:
        with urllib.request.urlopen(endpoint + "/metrics", timeout=60) as r:
            return json.load(r)["read_coalescer"]

    try:
        for clients, writer in LOAD_RUNS:
            before = coalescer()
            cmd = [sys.executable, os.path.join(tools, "load_test_torch.py"),
                   "--endpoint", endpoint, "--clients", str(clients),
                   "--duration", str(LOAD_DURATION_S)]
            t = time.perf_counter()
            res = subprocess.run(cmd + (["--writer"] if writer else []),
                                 capture_output=True, text=True, cwd=root,
                                 timeout=LOAD_DURATION_S + 300)
            wall = time.perf_counter() - t
            lines = [x for x in res.stdout.splitlines() if x.startswith("{")]
            if res.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"load {clients} clients: rc "
                                     f"{res.returncode}\n{res.stderr[-3000:]}")
            summary = json.loads(lines[0])
            after = summary["read_coalescer"]
            batches = after["batches"] - before["batches"]
            requests = after["requests"] - before["requests"]
            run = dict(summary, writer=writer, tool_process_s=wall,
                       run_batches=batches, run_requests=requests,
                       run_mean_coalesced_batch=requests / batches
                       if batches else None)
            log("[load] " + json.dumps({"card": card, **run}))
            if summary["errors"] or not summary["reads"]:
                raise AssertionError(f"load {clients} clients: "
                                     f"{summary['errors']} errors "
                                     f"{summary['error_samples']}, "
                                     f"{summary['reads']} reads")
            if clients == 16 and requests <= batches:
                raise AssertionError(f"16 clients never coalesced: "
                                     f"{requests} requests in {batches} "
                                     f"batches")
            out["runs"].append(run)
    finally:
        tool.stop_server(proc)
    log(f"[load] {card}: " + "; ".join(
        f"{r['clients']} clients{' + writer' if r['writer'] else ''} "
        f"{r['qps']:.1f} reads/s, p50 {r['latency_ms']['p50']:.1f} ms, p99 "
        f"{r['latency_ms']['p99']:.1f} ms, batch {r['run_mean_coalesced_batch']:.2f}"
        for r in out["runs"]))
    return out


def direct_params(params):
    """``params`` with direct-upload queries (sdk_tpu/params.py:259): each
    request carries its scan columns, its GSW keys and its public params,
    and the server expands nothing."""
    from sdk_tpu_torch.params import params_from_json, params_to_json_obj

    return params_from_json(json.dumps({**params_to_json_obj(params),
                                        "direct_upload": 1}))


def direct_blob(params, seed: int, idx: int):
    """A seeded client and its direct-upload request for item ``idx``: the
    serialized public params, then the query."""
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.rng import ChaCha20Rng

    client = Client(params)
    setup = client.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32).serialize(params)
    query = client.generate_query(idx, noise_rng=ChaCha20Rng(
        bytes([seed + 3]) * 32), query_seed=bytes([seed + 4]) * 32)
    return client, setup + query.serialize(params)


def direct_small(dev) -> dict:
    """The small direct-upload config (tests/test_kv_service.py:137) on the
    card and on the CPU: a single read and a 3-query batch (padded to 4),
    byte for byte, every response decoded."""
    from sdk_tpu_torch.client import PublicParameters, Query
    from sdk_tpu_torch.ops.server import SpiralServerTorch
    from sdk_tpu_torch.params import params_from_json

    params = params_from_json(DIRECT_SMALL)
    rows, db = small_db(params, np.random.default_rng(SEED + 10), "cpu")
    head = params.setup_bytes()
    idxs = [(5 + 41 * i) % params.num_items() for i in range(3)]
    made = [direct_blob(params, 0x20 + 8 * i, idx)
            for i, idx in enumerate(idxs)]
    reqs = [(PublicParameters.deserialize(params, b[:head]),
             Query.deserialize(params, b[head:])) for _, b in made]
    out = {}
    for device in (dev, "cpu"):
        srv = SpiralServerTorch(params, device)
        srv.set_db(db)
        out[str(device)] = ([srv.process_query(*reqs[0])]
                            + srv.dispatch_queries_batched(reqs)())
    got = out[str(dev)]
    if got != out["cpu"]:
        raise AssertionError("direct small: card responses differ from the "
                             "CPU plain versions'")
    # got: the single read of request 0, then the batch of requests 0-2
    for k, resp in zip([0, 0, 1, 2], got):
        idx = idxs[k]
        if made[k][0].decode_response(resp)[:len(rows[idx])] != rows[idx]:
            raise AssertionError("direct small: a response does not decode")
    log(f"[direct] small config {DIRECT_SMALL}: a read and a 3-query batch "
        f"on the card equal the CPU plain versions byte for byte, decode")
    return {"response_bytes": len(got[0])}


def direct_stage_breakdown(srv, blobs: list, reps: int = 3) -> dict:
    """Wall ms of each stage of a direct-upload dispatch of ``blobs``,
    synchronised per stage (the launches are not counted): parse
    (PublicParameters.deserialize and Query.deserialize of every blob, on
    the host; taken once), keys (pp_to_device), columns (the buffers'
    upload and unpack, direct_columns), ntt_keys (kernel A on the GSW keys
    and their negation, direct_keys), scan, fold (A' and F) and pack_encode
    (G); medians of ``reps`` for all but parse."""
    from sdk_tpu_torch.client import PublicParameters, Query
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.server import pp_to_device
    from sdk_tpu_torch.ops.shard import fold_columns

    eng = srv.engine
    params = eng.params
    head = params.setup_bytes()
    nq = len(blobs)
    pad = 1 << (nq - 1).bit_length()
    t = time.perf_counter()
    parsed = [(PublicParameters.deserialize(params, b[:head]),
               Query.deserialize(params, b[head:])) for b in blobs]
    out = {"parse": (time.perf_counter() - t) * 1e3}
    queries = [q for _, q in parsed]
    times: dict[str, list] = {k: [] for k in ("keys", "columns", "ntt_keys",
                                              "scan", "fold", "pack_encode")}
    for _ in range(reps):
        torch.cuda.synchronize()
        stamps = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        pps = [pp_to_device(params, pp, eng.device) for pp, _ in parsed]
        mark()
        cols = eng.direct_columns(queries, pad)
        mark()
        v_folding, v_neg = eng.direct_keys(queries)
        mark()
        inter = sj.firstdim_multiply(params, eng.db, cols)
        mark()
        inter = inter.reshape(inter.shape[:-1] + (pad, 2))[..., :nq, :]
        folded = fold_columns(params, inter, v_folding, v_neg)
        mark()
        eng._pack_encode(folded, [pp["v_packing"] for pp in pps])
        mark()
        for k, a, b in zip(times, stamps, stamps[1:]):
            times[k].append((b - a) * 1e3)
    out.update({k: float(np.median(v)) for k, v in times.items()})
    return out


def check_direct_launches(params, per_read: dict, per_batch: dict) -> None:
    """A direct-upload read and 16-batch of the 1 GiB bucket make the same
    DIRECT_READ_LAUNCHES hand launches: A on the batch's GSW keys, the
    scan, the fold input's A', one F a round and one G; no expansion,
    regev_to_gsw, B or D."""
    want = {"ntt_forward": 1, "scan": 1, "ntt_inverse": 1,
            "fold_round": params.db_dim_2, "pack": 1}
    if per_read != per_batch or per_read != want \
            or sum(per_read.values()) != DIRECT_READ_LAUNCHES:
        raise AssertionError(f"direct hand launches: a read {per_read}, a "
                             f"16-batch {per_batch}; want {want} "
                             f"({DIRECT_READ_LAUNCHES}) each")
    log(f"[direct] hand launches: {DIRECT_READ_LAUNCHES} for a read and for a "
        f"16-batch ({per_read})")


def phase_direct(params, dev, launches: Launches) -> dict:
    """Direct-upload reads of the full 1 GiB bucket (the bucket's params
    with "direct_upload": 1; an 8.59 GB dense index): the small config
    against the CPU first, then 4 distinct seeded requests (each made once
    on the host: seconds a query) read alone and in two 16-query batches
    through dispatch_read_blobs, every response decoded; the launch counts;
    the stage split; one read and 4 readers at once over HTTP."""
    from sdk_tpu_torch.clients.api import API
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.server.http import serve
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    out = {"small": direct_small(dev)}
    dparams = direct_params(params)
    out["query_bytes"] = dparams.query_bytes()
    out["setup_bytes"] = dparams.setup_bytes()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = SpiralKvServerTorch(dparams, device=dev)
    n_items = dparams.num_items()
    gen = np.random.default_rng(SEED + 11)
    step = n_items // 8
    for s in range(0, n_items, step):
        for i, data in random_rows(dparams, gen, range(s, s + step)).items():
            srv.update_item_raw(i, data)
        srv.flush()
    keys = distinct_row_keys(n_items, 4)
    values = {k: bytes(gen.integers(0, 256, value_len(dparams),
                                     dtype=np.uint8)) for k in keys}
    write_values(srv, values)
    srv.flush()
    out["fill_s"] = time.perf_counter() - t0
    meta = srv.meta()
    if meta["index_layout"] != "dense" or meta["sparse_expansion"] \
            or srv.engine._splan is not None \
            or meta["pir_scheme"].get("direct_upload") != 1:
        raise AssertionError(f"direct bucket: {meta}")
    log(f"[direct] filled {n_items} items and {len(keys)} keys in "
        f"{out['fill_s']:.1f} s; dense index, no sparse expansion plan; "
        f"{out['query_bytes']} query + {out['setup_bytes']} setup bytes a "
        f"request")

    from sdk_tpu_torch.kv.key_value import row_from_key

    t = time.perf_counter()
    made = [direct_blob(dparams, 0x90 + 8 * i, row_from_key(n_items, k))
            for i, k in enumerate(keys)]
    out["client_keys_and_query_s_each"] = (time.perf_counter() - t) / 4
    clients = [c for c, _ in made]
    single = [b for _, b in made]
    batch = [single[i % 4] for i in range(16)]

    def reads(blob_lists):
        walls, resps = [], []
        for blobs in blob_lists:
            t = time.perf_counter()
            resps.append(srv.dispatch_read_blobs(blobs)())
            walls.append((time.perf_counter() - t) * 1e3)
        return walls, resps

    (lat, r1), c1 = launches.run(lambda: reads([[b] for b in single]))
    (bt, r16), c16 = launches.run(lambda: reads([batch, batch]))
    for i, resp in enumerate(r1):
        check_value(clients[i], resp[0], keys[i], values[keys[i]])
    for resps in r16:
        if resps[:4] != [r[0] for r in r1]:
            raise AssertionError("a 16-batch's responses differ from the "
                                 "single reads' bytes")
        for i, resp in enumerate(resps):
            check_value(clients[i % 4], resp, keys[i % 4], values[keys[i % 4]])
    per_read = {k: v // 4 for k, v in c1.items() if v}
    per_batch = {k: v // 2 for k, v in c16.items() if v}
    check_direct_launches(dparams, per_read, per_batch)
    out.update(single_read_ms_all=lat,
               single_read_ms_median=float(np.median(lat)),
               batch16_ms_all=bt, batch16_ms_median=float(np.median(bt)),
               launches_per_single_read=per_read,
               launches_per_batch16=per_batch,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    log(f"[direct] 4 single reads and 2 x 16-query batches through "
        f"dispatch_read_blobs decoded; single median "
        f"{out['single_read_ms_median']:.2f} ms, batch "
        f"{out['batch16_ms_median']:.2f} ms")
    out["stages_ms_single"] = direct_stage_breakdown(srv, single[:1])
    out["stages_ms_batch16"] = direct_stage_breakdown(srv, batch)
    log(f"[direct] stages, a read {out['stages_ms_single']} ms; a 16-batch "
        f"{out['stages_ms_batch16']} ms")

    httpd = serve(srv, 0, block=False, batch_window_ms=DIRECT_BATCH_WINDOW_MS)
    base = f"http://localhost:{httpd.server_address[1]}"
    out["batch_window_ms"] = DIRECT_BATCH_WINDOW_MS
    try:
        api = API("", base)
        if api.meta()["pir_scheme"].get("direct_upload") != 1:
            raise AssertionError("/meta does not say direct_upload")
        t = time.perf_counter()
        resp = api.private_read("", [single[0]])[0]
        out["http_single_ms"] = (time.perf_counter() - t) * 1e3
        check_value(clients[0], resp, keys[0], values[keys[0]])
        results: dict = {}
        errors: list = []
        gate = threading.Barrier(4)

        def reader(i):
            try:
                gate.wait()
                results[i] = api.private_read("", [single[i]])[0]
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(4)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        out["http_4_readers_wall_ms"] = (time.perf_counter() - t) * 1e3
        if errors:
            raise errors[0]
        for i in range(4):
            check_value(clients[i], results[i], keys[i], values[keys[i]])
        out["read_coalescer"] = api._get(base + "/metrics")["read_coalescer"]
        if out["read_coalescer"]["max_batch"] <= 1:
            raise AssertionError(f"4 concurrent direct readers were not "
                                 f"coalesced: {out['read_coalescer']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"[direct] over HTTP: a read {out['http_single_ms']:.2f} ms; 4 "
        f"readers at once {out['http_4_readers_wall_ms']:.2f} ms (coalescer "
        f"{out['read_coalescer']}), decoded")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_client_test(dev) -> dict:
    """The CLIENT_TEST hook on the card (fast params and the small direct
    config): with the right target a single read passes and answers the
    bytes it answers without the hook; with a wrong one it raises
    ClientTestFailure after the fold and before G (no pack launch)."""
    from sdk_tpu_torch import _build, debug_hooks
    from sdk_tpu_torch.client import Client
    from sdk_tpu_torch.ops.server import SpiralServerTorch
    from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                      params_from_json)
    from sdk_tpu_torch.rng import ChaCha20Rng

    out = {}
    gen = np.random.default_rng(SEED + 12)
    for label, params in (("fast v0", get_fast_expansion_testing_params()),
                          ("direct small", params_from_json(DIRECT_SMALL))):
        rows, db = small_db(params, gen, dev)
        target = 29 % params.num_items()
        client = Client(params)
        pp = client.generate_keys_from_seed(
            b"\x31" * 32, noise_rng=ChaCha20Rng(b"\x32" * 32),
            pp_seed=b"\x33" * 32)
        query = client.generate_query(target, noise_rng=ChaCha20Rng(
            b"\x34" * 32), query_seed=b"\x35" * 32)
        srv = SpiralServerTorch(params, dev)
        srv.set_db(db)
        plain = srv.process_query(pp, query)
        # p = 256: the mod-p words of instance 0 / trial 0 are the row's
        # first chunk of bytes
        chunk = np.zeros(params.poly_len, dtype=np.uint64)
        first = np.frombuffer(rows[target][:params.bytes_per_chunk()],
                              dtype=np.uint8)
        chunk[:len(first)] = first
        try:
            debug_hooks.set_client_test(client.sk_reg, chunk)
            _build.reset_launches()
            hooked = srv.process_query(pp, query)
            ok_counts = dict(_build.LAUNCHES)
            bad = (chunk + np.uint64(1)) % np.uint64(params.pt_modulus)
            debug_hooks.set_client_test(client.sk_reg, bad)
            _build.reset_launches()
            try:
                srv.process_query(pp, query)
            except debug_hooks.ClientTestFailure as e:
                width = e.noise_width_log2
            else:
                raise AssertionError(f"{label}: a wrong target passed")
            bad_counts = dict(_build.LAUNCHES)
        finally:
            debug_hooks.clear_client_test()
        if hooked != plain or ok_counts["pack"] != 1:
            raise AssertionError(f"{label}: the hook changed the response "
                                 f"or G did not run: {ok_counts}")
        if bad_counts["pack"] != 0 or bad_counts["fold_round"] <= 0:
            raise AssertionError(f"{label}: a failing check must stop "
                                 f"after F and before G: {bad_counts}")
        out[label] = {"launches_passing": {k: v for k, v in
                                           ok_counts.items() if v},
                      "launches_failing": {k: v for k, v in
                                           bad_counts.items() if v},
                      "failing_noise_width_log2": width}
        log(f"[client_test] {label}: the right target passes with the "
            f"same bytes; a wrong one raises ClientTestFailure after F, "
            f"with no G launch ({bad_counts['fold_round']} F, noise width "
            f"log2 {width:.2f})")
    return out


def phase_traces() -> dict:
    """tools/profile_trace_torch.py on the 16-batch of expansion queries
    and on the direct-upload 16-batch, each in a process of its own (a
    profiler session slows every later launch of its process); the traces
    are written under build/traces/. Returns their JSON lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for target, iters, want in (("batch16", 2, READ_LAUNCHES),
                                ("direct", 1, DIRECT_READ_LAUNCHES)):
        res = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "profile_trace_torch.py"),
             "--target", target, "--iters", str(iters), "--out",
             os.path.join(root, "build", "traces", target)],
            capture_output=True, text=True, timeout=600, cwd=root)
        if res.returncode != 0:
            raise AssertionError(f"profile_trace_torch --target {target}: "
                                 f"rc {res.returncode}\n{res.stderr[-3000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        counted = sum(line["launches_per_iter"].values())
        if counted != want:
            raise AssertionError(f"traced {target}: {counted} hand launches "
                                 f"an iteration, want {want}")
        traced = [r["hand_launches"] for r in line["reads"]]
        if any(n not in (0, want) for n in traced):
            raise AssertionError(f"traced {target}: the trace holds "
                                 f"{traced} hand kernels, want {want}")
        print("[trace] " + json.dumps(line), flush=True)
        out[target] = {k: line.get(k) for k in ("trace_file",
                                                "idle_share_median",
                                                "window_ms_median")}
    return out


# the mesh across processes: (label, backend, ranks), each rank on cuda:0
MULTIPROC_RUNS = (("gloo_2_ranks", "gloo", 2), ("nccl_1_rank", "nccl", 1))


def phase_multiproc() -> dict:
    """tools/multiproc_worker_torch.py --case bucket for each of
    MULTIPROC_RUNS, over a fresh store under build/; any rank's failure, a
    timeout (every rank is then killed) or a result that is not exact with
    one M launch a rank fails the phase. Returns rank 0's JSON lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import multiproc_worker_torch as worker

    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    base = tempfile.mkdtemp(prefix="multiproc_", dir=os.path.join(root, "build"))
    out = {}
    for label, backend, world in MULTIPROC_RUNS:
        t = time.perf_counter()
        ranks = worker.run_ranks(world, os.path.join(base, label),
                                 ["--backend", backend, "--case", "bucket"],
                                 timeout=300)
        for r, (rc, _, err) in enumerate(ranks):
            if rc != 0:
                raise AssertionError(f"multiproc {label}: rank {r} rc {rc}"
                                     f"\n{err[-3000:]}")
        lines = [json.loads(x) for x in ranks[0][1].splitlines()
                 if x.startswith("{")]
        if len(lines) != 1:
            raise AssertionError(f"multiproc {label}: {len(lines)} result "
                                 f"lines from rank 0")
        d = dict(lines[0], run_s=time.perf_counter() - t)
        want = {"backend": backend, "world": world, "ok": True,
                "m_launches": [1] * world,
                "c_launches": [worker.LOCAL_PARTS] * world,
                "max_abs_err_plain": [0] * world,
                "max_abs_err_whole_index": 0,
                "same_result_on_every_rank": True}
        bad = {k: d.get(k) for k, v in want.items() if d.get(k) != v}
        if bad:
            raise AssertionError(f"multiproc {label}: {bad}, want "
                                 f"{ {k: want[k] for k in bad} }")
        log("[multiproc] " + json.dumps(d))
        out[label] = d
    log(f"[multiproc] {', '.join(out)}: psum_mod_group's sums of the 1 GiB "
        f"bucket's scan partials equal C over the whole index; one M launch "
        f"a rank")
    return out


def dev_u32(gen: torch.Generator, shape, dev) -> torch.Tensor:
    """Random uint32 bit patterns as int32, made on the card."""
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64,
                         device=dev, generator=gen).to(torch.int32)


def dev_i8(gen: torch.Generator, shape, dev, low=-128, high=128):
    """Random int8 in kernel K's aligned rows."""
    from sdk_tpu_torch.doublepir.server_torch import aligned_rows

    out = aligned_rows(shape[0], shape[1], dev)
    out.copy_(torch.randint(low, high, shape, dtype=torch.int8, device=dev,
                            generator=gen))
    return out


def phase_doublepir_kernels(dev, table: KernelTable,
                            config: str = CHECKLIST) -> None:
    """K and L against their plain versions at the checklist path's shapes
    (row slices of the DB and of the digit planes, full K and N)."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.doublepir import kernels as dk, server_torch as st
    from sdk_tpu_torch.doublepir.params import Params

    params = Params.from_string(config)
    l, m, n, p = params.l, params.m, params.n, params.p
    l3 = -(-l // 3) * 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    name = "dp_dot_i8"

    # setup: H1 = DB @ A1 + (128 - p/2) colsum(A1), and one H2 digit plane
    # (K past one s32 run of 65,536; H1 checked on a launch of 4,169 rows,
    # whose last row band holds 9 rows as the whole DB's does, at its first
    # 128 and last 73 rows; timed on a 4,224-row sample: 66 row bands of 64
    # x 8 column tiles of 128, four blocks for each of the 132 SMs)
    a1 = dev_u32(gen, (m, n), dev)
    trows = 33 * 128
    db_rows = dev_i8(gen, (trows, m), dev)
    c1 = 128 - p // 2
    ragged = trows - 55
    h1 = st.dot_i8_u32(db_rows[:ragged], a1, c=c1)
    for r0, r1 in ((0, 128), (ragged - 73, ragged)):
        table.check(name, f"setup H1, rows {r0}..{r1} of a {ragged}-row "
                    "launch", max_abs_err(h1[r0:r1], st._dot_plain(
                        db_rows[r0:r1], None, a1, c1, False)))
    del h1
    tiled_ms = cuda_ms(lambda: st.dot_i8_u32(db_rows, a1, c=c1), 5)
    tiled_bytes = nbytes(db_rows, a1) + 4 * trows * n
    # four byte planes of A1 on the int8 tensor cores; the CUDA-core form's
    # one 32-bit multiply-add a product beside it
    tiled_b = bound(tiled_bytes, 4 * 2 * trows * m * n, INT8_OPS_PER_S)
    tiled_b32 = bound(tiled_bytes, 2 * trows * m * n, INT32_OPS_PER_S)
    # the library yardstick: torch._int_mm over the same int8 rows (with
    # their row padding) x an (m, 4n) int8 operand, the four planes'
    # tensor-core work, its second operand row-major and column-major (the
    # layout cuBLASLt's int8 kernels take as they are); the faster counts.
    # The port never calls it
    stride = db_rows.stride(0)
    whole = torch.as_strided(db_rows, (trows, stride), (stride, 1))
    ones = torch.ones((stride, 4 * n), dtype=torch.int8, device=dev)
    lib_layouts = {"row_major": cuda_ms(lambda: torch._int_mm(whole, ones), 5)}
    ones = ones.t().contiguous().t()
    lib_layouts["col_major"] = cuda_ms(lambda: torch._int_mm(whole, ones), 5)
    tiled_lib = min(lib_layouts.values())
    del whole, ones
    a2 = dev_u32(gen, (l, n), dev)
    lo, hi = dev_i8(gen, (128, l), dev, 0, 128), dev_i8(gen, (128, l), dev, 0, 4)
    table.check(name, "setup H2 pair, 128 digit rows", max_abs_err(
        st.dot_i8pair_u32(lo, hi, a2, c=-(p // 2)),
        st._dot_plain(lo, hi, a2, -(p // 2), False)))
    del a1, a2, lo, hi, db_rows
    torch.cuda.empty_cache()

    # answer: the hint matvec a_2 (pair, 8 columns) and the level-1 pass
    # with its row-batch select, nq = 8 and 1
    q2 = dev_u32(gen, (l3, 8), dev)
    lo, hi = dev_i8(gen, (512, l3), dev, 0, 128), dev_i8(gen, (512, l3), dev, 0, 4)
    table.check(name, "answer a_2 (narrow form), 512 hint rows x 8", max_abs_err(
        st.dot_i8pair_u32(lo, hi, q2), st._dot_plain(lo, hi, q2, 0, False)))
    del lo, hi
    rows = 2048
    db_rows = dev_i8(gen, (rows, m), dev)
    for nq in (8, 1):
        q1 = dev_u32(gen, (m, nq), dev)
        table.check(name, f"answer level 1 select, {rows} DB rows, nq={nq}",
                    max_abs_err(st.dot_i8_select(db_rows, q1, c=128),
                                st._dot_plain(db_rows, None, q1, 128, True)))
    q1 = dev_u32(gen, (m, 8), dev)
    table.timed(
        name, "sdk_tpu_torch/csrc/dp_dot_i8.cu",
        "sdk_tpu/doublepir/server_jax.py:52",
        f"answer level 1 with the row-batch select: ({rows}, {m}) int8 rows "
        f"of the DB @ ({m}, 8) u32, one column per row batch (ms, plain_ms, "
        f"bound_ms, library_ms); the whole DB in level1_full_*; the tiled "
        f"form (setup H1 on a {trows}-row sample x {n} columns: one int8 "
        f"tensor-core product a byte plane of A1) in tiled_*, its bound "
        f"over 4 planes at the int8 peak and the CUDA-core form's at the "
        f"32-bit peak (tiled_int32_*), tiled_library_ms torch._int_mm over "
        f"the sample's int8 rows x ({m}, {4 * n}) int8; library_ms: "
        f"torch._int_mm over the same int8 bytes x 8 int8 columns (no 32-bit "
        f"operand, no select)",
        cuda_ms(lambda: st.dot_i8_select(db_rows, q1, c=128), 20),
        cuda_ms(lambda: st._dot_plain(db_rows, None, q1, 128, True), 2),
        bound(nbytes(db_rows, q1) + 4 * rows, 2 * rows * m, INT32_OPS_PER_S),
        int_mm_ms(db_rows.contiguous()),
        tiled_ms=tiled_ms, tiled_bound_ms=tiled_b["bound_ms"],
        tiled_bound_by=tiled_b["bound_by"],
        tiled_int32_bound_ms=tiled_b32["bound_ms"],
        tiled_int32_bound_by=tiled_b32["bound_by"],
        tiled_library_ms=tiled_lib, tiled_ptxas=tiled_ptxas())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[K tiled] sample {tiled_ms:.4f} ms against its int8 bound "
        f"{tiled_b['bound_ms']:.4f}; torch._int_mm {lib_layouts} ms; the "
        f"schedule's HBM bytes by an analytic model (not measured; a wave of "
        f"{sms} blocks reads its row bands and column tiles once): sample "
        f"{tiled_hbm_bytes(trows, m, n, 64, 128, sms)}, whole H1 "
        f"{tiled_hbm_bytes(l, m, n, 64, 128, sms)}")
    del db_rows, q1

    # L: msg0 = a_1t (4 x l3, packed) @ A2, h_2 = a_1t @ q2, and the general
    # configs' shapes (packed DB rows @ one query column; a setup product)
    name = "dp_matmul_u32"
    a2p = dev_u32(gen, (l3, n), dev)
    a_1t = dev_u32(gen, (4, l3 // 3), dev) & 0x3FFFFFFF
    cases = [("msg0 packed", a_1t, a2p, True),
             ("h_2 packed", a_1t, q2, True),
             ("msg0 unpacked", dk.unsquish(a_1t, l3), a2p, False),
             ("packed DB rows @ a query column",
              dev_u32(gen, (3000, 1000), dev) & 0x3FFFFFFF,
              dev_u32(gen, (3000, 1), dev), True),
             ("setup product of a general config",
              dev_u32(gen, (300, 3001), dev), dev_u32(gen, (3001, 200), dev),
              False)]
    for label, a, b, packed in cases:
        fn, plain = (dk.mat_mul_vec_packed, dk.matmul_u32_packed_plain) \
            if packed else (dk.matmul_u32, dk.matmul_u32_plain)
        table.check(name, label, max_abs_err(fn(a, b), plain(a, b)))
    # the answer form: msg0 and h_2 in one launch, nq = 8 and 1
    q2_1 = dev_u32(gen, (l3, 1), dev)
    for nq, q in ((8, q2), (1, q2_1)):
        for g, w in zip(dk.answer_products(a_1t, a2p, q),
                        dk.answer_products_plain(a_1t, a2p, q)):
            table.check(name, f"answer form msg0 + h_2, nq={nq}",
                        max_abs_err(g, w))
    answer_b = bound(nbytes(a_1t, a2p, q2) + 4 * 4 * (n + 8),
                     2 * 4 * l3 * (n + 8), INT32_OPS_PER_S)
    table.timed(
        name, "sdk_tpu_torch/csrc/dp_matmul_u32.cu",
        "sdk_tpu/doublepir/jax_kernels.py:35",
        f"the answer form (the checklist answer's launch): msg0 = packed "
        f"a_1t (4, {l3 // 3}) words of three 10-bit fields @ A2 ({l3}, {n}) "
        f"u32 and h_2 = a_1t @ q2 ({l3}, 8) in one launch (ms, plain_ms: the "
        f"two plain products, bound_ms: A2 + q2 + a_1t); answer_nq1_* at "
        f"q2 ({l3}, 1); parent_* the two packed launches before it (msg0_* "
        f"and h2_* each alone)",
        cuda_ms(lambda: dk.answer_products(a_1t, a2p, q2), 20),
        cuda_ms(lambda: dk.answer_products_plain(a_1t, a2p, q2), 3),
        answer_b,
        answer_nq1_ms=cuda_ms(lambda: dk.answer_products(a_1t, a2p, q2_1),
                              20),
        parent_ms=cuda_ms(lambda: (dk.mat_mul_vec_packed(a_1t, a2p),
                                   dk.mat_mul_vec_packed(a_1t, q2)), 20),
        msg0_ms=cuda_ms(lambda: dk.mat_mul_vec_packed(a_1t, a2p), 20),
        msg0_bound_ms=bound(nbytes(a_1t, a2p) + 4 * 4 * n, 2 * 4 * l3 * n,
                            INT32_OPS_PER_S)["bound_ms"],
        h2_ms=cuda_ms(lambda: dk.mat_mul_vec_packed(a_1t, q2), 20),
        h2_plain_ms=cuda_ms(lambda: dk.matmul_u32_packed_plain(a_1t, q2), 3),
        **{f"h2_{k}": v for k, v in bound(
            nbytes(a_1t, q2) + 4 * 4 * 8, 2 * 4 * l3 * 8,
            INT32_OPS_PER_S).items()},
        answer_blocks=_build.lib()["sdk_dp_answer_blocks"](),
        answer_ptxas={("vec" if "ILb1E" in k else "scalar"): v for k, v in
                      _build.ptxas_usage("dp_matmul_u32").items()
                      if "answer_kernel" in k})
    del q2_1


def planted_bits(gen: np.random.Generator, num_entries: int) -> np.ndarray:
    return gen.integers(0, 256, (num_entries + 7) // 8,
                        dtype=np.uint16).astype(np.uint8)


def phase_doublepir_small(dev) -> None:
    """Small configs on the card against the port's own numpy scheme: the
    hint and every answer matrix word for word, every planted bit
    recovered."""
    from sdk_tpu_torch.doublepir import scheme
    from sdk_tpu_torch.doublepir.client import DoublePirClient
    from sdk_tpu_torch.doublepir.database import Db
    from sdk_tpu_torch.doublepir.params import Params
    from sdk_tpu_torch.doublepir.serializer import serialize_state
    from sdk_tpu_torch.doublepir.server_torch import ChecklistServerTorch
    from sdk_tpu_torch.server.doublepir_server import DoublePirKvServerTorch

    gen = np.random.default_rng(SEED + 5)
    for config in ("64,6.4,13,17,32,464", "1024,6.4,2048,2050,32,464"):
        params = Params.from_string(config)
        num_entries = params.l * params.m * 8 - 5
        bit_bytes = planted_bits(gen, num_entries)
        db = Db.from_packed_bits(num_entries, params, bit_bytes)
        shared = scheme.init(db.info, params)
        state, hint = scheme.setup(db, shared, params)
        srv = ChecklistServerTorch(num_entries, params, bit_bytes)
        if srv.device.type != dev.type:
            raise AssertionError(f"default device is {srv.device}")
        hint_dev = srv.setup_streamed()
        if not (np.array_equal(hint_dev[0], hint[0])
                and np.array_equal(srv.h1_sq, state[0])):
            raise AssertionError(f"{config}: card hint != numpy scheme")
        bits = np.unpackbits(bit_bytes, bitorder="little")
        client = DoublePirClient(params, db.info, shared)
        client.hint = hint_dev
        recovered = 0
        for nq in (1, 4, 8):
            targets = [int(t) for t in gen.integers(0, num_entries, nq)]
            queries, datas, plan = client.generate_query_batch(targets, gen)
            got = srv.answer(queries)
            want = scheme.answer(db, queries, state, params)
            if len(got) != len(want) or not all(
                    np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{config} nq={nq}: card answer != "
                                     f"numpy scheme")
            raw = serialize_state(got)
            for b, entry in enumerate(plan):
                if entry is None:
                    continue
                val = client.decode_response(raw, entry[0], b, datas[b])
                if val != int(bits[entry[0]]):
                    raise AssertionError(f"{config}: bit {entry[0]} "
                                         f"recovered as {val}")
                recovered += 1
        log(f"[dp small] {config}: hint, squished H1 and the answers for "
            f"nq = 1, 4, 8 equal the numpy scheme word for word; "
            f"{recovered} planted bits recovered")

    # a general config (p=991: 9 entries per element) through the bucket
    log2m = 17
    params = Params.from_string("1024,6.4,128,128,32,991")
    srv = DoublePirKvServerTorch(log2m, params)
    keys = [f"member-{i}" for i in range(40)]
    srv.add_keys(keys)
    hint_bytes = srv.get_hint()
    if srv._engine is not None:
        raise AssertionError("p=991 must take the general branch")
    db = Db.from_packed_bits(1 << log2m, params, srv.bit_bytes)
    shared = scheme.init(db.info, params)
    state, hint = scheme.setup(db, shared, params)
    if hint_bytes != serialize_state(hint):
        raise AssertionError("general config: card hint != numpy scheme")
    for key, member in ((keys[3], True), ("not-a-member", False)):
        client, qb, queries, datas, plan = checklist_batch(srv, key, gen)
        raw = srv.answer(qb)
        if raw != serialize_state(scheme.answer(db, queries, state, params)):
            raise AssertionError("general config: card answer != numpy scheme")
        got = decode_plan(client, raw, datas, plan)
        if (0 not in got) != member:
            raise AssertionError(f"general config: {key!r} decoded {got}")
    log("[dp small] 1024,6.4,128,128,32,991 (general branch): hint and "
        "answer bytes equal the numpy scheme; member found, non-member not")


def checklist_batch(srv, key: str, gen: np.random.Generator, client=None):
    """The 8-query batch a client's check_inclusion sends for ``key`` (one
    query per bloom index, planned one per row batch)."""
    from sdk_tpu_torch.clients.bloom import bloom_hash
    from sdk_tpu_torch.doublepir.client import DoublePirClient
    from sdk_tpu_torch.doublepir.serializer import serialize_states
    from sdk_tpu_torch.server.doublepir_server import BLOOM_K

    if client is None:
        meta = srv.meta()["pir_scheme"]
        client = DoublePirClient.from_strings(meta["params"], meta["dbinfo"])
        client.load_hint(srv.get_hint())
    idxs = [bloom_hash(key, i, srv.log2m) for i in range(BLOOM_K)]
    queries, datas, plan = client.generate_query_batch(idxs, gen)
    return client, serialize_states(queries), queries, datas, plan


def decode_plan(client, raw: bytes, datas, plan) -> list[int]:
    return [client.decode_response(raw, e[0], b, datas[b])
            for b, e in enumerate(plan) if e is not None]


def answer_breakdown(srv, body: bytes) -> dict:
    """Median wall ms of the three stages of one checklist answer: query
    bytes -> matrices, the engine's answer (uploads, four launches, digit
    glue, fetch), matrices -> response bytes."""
    from sdk_tpu_torch.doublepir.serializer import (deserialize_states,
                                                    serialize_state)

    times: dict[str, list] = {"deserialize": [], "engine_answer": [],
                              "serialize": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        queries = deserialize_states(body)
        t1 = time.perf_counter()
        resp = srv._engine.answer(queries)
        t2 = time.perf_counter()
        serialize_state(resp)
        t3 = time.perf_counter()
        for k, v in zip(times, (t1 - t, t2 - t1, t3 - t2)):
            times[k].append(v * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def phase_checklist_full(dev, table: KernelTable, launches: Launches,
                         log2m: int = 36, config: str = CHECKLIST,
                         n_keys: int = 300) -> dict:
    """The production checklist bucket, end to end on the card."""
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.clients.bloom import bloom_hash
    from sdk_tpu_torch.doublepir import kernels as dk, server_torch as st
    from sdk_tpu_torch.doublepir.serializer import serialize_states
    from sdk_tpu_torch.server.doublepir_server import DoublePirKvServerTorch

    gen = np.random.default_rng(SEED + 6)
    torch.cuda.reset_peak_memory_stats(dev)
    srv = DoublePirKvServerTorch(log2m)          # the default device: cuda
    if srv.params.to_string() != config or srv.device.type != dev.type:
        raise AssertionError(f"want {config} on the card, got "
                             f"{srv.params.to_string()} on {srv.device}")
    members = [f"breached-password-{i:04d}" for i in range(n_keys)]
    srv.add_keys(members)
    # the hint setup as a user meets it: no wrapper, no added synchronize
    t = time.perf_counter()
    hint_bytes, setup_counts = launches.run(srv.get_hint)
    setup_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    # one H1 launch over the whole DB and one H2 launch a digit plane
    k_setup = 1 + srv.params.delta()
    if srv._engine is None or setup_counts["dp_dot_i8"] != k_setup:
        raise AssertionError(f"setup did not run the device engine's "
                             f"{k_setup} K launches: {setup_counts}")

    # the same rebuild again (a write of a bit already set: the same
    # filter), split into its parts, with H1's first and last row bands
    # (the last holds 9 rows) held against the plain version
    def check_h1(h1, a, b, c=0):
        rows = a.shape[0]
        for r0, r1 in ((0, 64), (rows - 73, rows)):
            table.check("dp_dot_i8", f"setup H1 over the whole DB, rows "
                        f"{r0}..{r1}", max_abs_err(h1[r0:r1], st._dot_plain(
                            a[r0:r1], None, b, c, False)))

    srv.set_bit(bloom_hash(members[0], 0, log2m))
    t = time.perf_counter()
    with setup_split(st, check_h1) as split:
        hint_again, counts_again = launches.run(srv.get_hint)
    split["wall_s"] = time.perf_counter() - t
    split["other_s"] = split["wall_s"] - split["db_upload_s"] \
        - split["derive_upload_s"] - split["setup_s"]
    if counts_again["dp_dot_i8"] != k_setup or hint_again != hint_bytes:
        raise AssertionError(f"the rebuild of the same filter: "
                             f"{counts_again}, same hint "
                             f"{hint_again == hint_bytes}")
    eng = srv._engine
    out = {"config": config, "num_entries": 1 << log2m,
           "db": f"bloom bits of {n_keys} keys in a host bit array, uploaded in "
                 "chunks, byte ^ 0x80 on the card",
           "db_bytes": eng.params.l * eng.params.m,
           "setup_wall_s": setup_s, "setup_split": split,
           "hint_bytes": len(hint_bytes),
           "setup_launches": setup_counts,
           "memory_allocated_after_setup": torch.cuda.memory_allocated(dev),
           "max_memory_allocated_setup": peak}
    log(f"[checklist] {config}: 2^{log2m} entries, {out['db_bytes']} DB "
        f"bytes on the card; setup with the AES-derived A1/A2 in "
        f"{setup_s:.2f} s; {k_setup} K launches; hint {len(hint_bytes)} "
        f"bytes; memory_allocated {out['memory_allocated_after_setup']}, "
        f"peak {peak}. The same rebuild split, each part synchronized: "
        f"{split['wall_s']:.2f} s = DB upload {split['db_upload_s']:.2f}, "
        f"derive and upload {split['derive_upload_s']:.2f}, H1 "
        f"{split['h1_s']:.3f}, glue {split['glue_s']:.3f}, "
        f"{len(split['h2_device_ms'])} H2 {split['h2_s']:.3f}, _install_a2 "
        f"{split['install_a2_s']:.3f}, H1's check {split['h1_check_s']:.2f}, "
        f"other {split['other_s']:.2f}")

    # a member whose 8 bloom indices fall into at least 5 of the 8 row
    # batches: a client declares membership on >= 5 planned bits
    bs = eng.params.l // 8
    member = next(k for k in members if len({
        min(bloom_hash(k, i, log2m) // 8 // eng.params.m // bs, 7)
        for i in range(8)}) >= 5)
    t = time.perf_counter()
    client, qb, queries, datas, plan = checklist_batch(srv, member, gen)
    out["client_batch_s"] = time.perf_counter() - t
    planned = sum(e is not None for e in plan)
    raw, counts = launches.run(lambda: srv.answer(qb))
    if counts["dp_dot_i8"] != 2 or counts["dp_matmul_u32"] != 1 \
            or sum(counts.values()) != 3:
        raise AssertionError(f"an answer is 2 K + 1 L launches: {counts}")
    table.rows["dp_dot_i8"].update(launches_per_answer=counts["dp_dot_i8"],
                                   launches_per_setup=k_setup)
    table.rows["dp_matmul_u32"].update(
        launches_per_answer=counts["dp_matmul_u32"])
    got = decode_plan(client, raw, datas, plan)
    if planned < 5 or got != [1] * planned:
        raise AssertionError(f"member: {planned} planned bits decoded {got}")
    # the same queries, tampered: the first-level vectors no longer select
    bad = [[q[0] ^ np.uint32(0x5A5A5A5A)] + list(q[1:]) for q in queries]
    got_bad = decode_plan(client, srv.answer(serialize_states(bad)), datas,
                          plan)
    if got_bad == [1] * planned:
        raise AssertionError("tampered queries still decoded")
    # one query alone (the interactive pattern), and a non-member
    b0 = next(b for b, e in enumerate(plan) if e is not None)
    one = serialize_states([queries[b0]])
    raw1, _ = launches.run(lambda: srv.answer(one))
    if client.decode_response(raw1, plan[b0][0], 0, datas[b0]) != 1:
        raise AssertionError("single-query answer did not decode")
    _, qb_n, _, datas_n, plan_n = checklist_batch(srv, "not-a-member", gen,
                                                  client)
    raw_n, _ = launches.run(lambda: srv.answer(qb_n))
    got_n = decode_plan(client, raw_n, datas_n, plan_n)
    if any(got_n):
        raise AssertionError(f"non-member bits decoded {got_n}")
    log(f"[checklist] member: {planned} planned bloom bits all 1; tampered "
        f"queries decoded {got_bad}; single query decoded; non-member's "
        f"{len(got_n)} bits all 0")

    def wall_ms(body: bytes) -> list:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            srv.answer(body)
            times.append((time.perf_counter() - t) * 1e3)
        return times

    for label, body in (("nq8", qb), ("nq1", one)):
        times = wall_ms(body)
        out[f"answer_wall_ms_{label}_median"] = float(np.median(times))
        out[f"answer_wall_ms_{label}_all"] = times
    out["launches_per_answer"] = counts
    out["answer_stages_ms_nq8"] = answer_breakdown(srv, qb)

    # the answer's kernels on the bucket's own operands
    q1 = dk.as_u32_tensor(np.concatenate(
        [q[0][:eng.params.m] for q in queries], axis=1), dev)
    q2 = dk.as_u32_tensor(np.concatenate([q[1] for q in queries], axis=1), dev)
    db_bytes = nbytes(eng.db)
    k_row = table.rows["dp_dot_i8"]
    for nq in (8, 1):
        q = q1[:, :nq].contiguous()
        ms = cuda_ms(lambda: st.dot_i8_select(eng.db, q, c=128), 5)
        b = bound(db_bytes + nbytes(q) + 4 * eng.params.l,
                  2 * db_bytes, INT32_OPS_PER_S)
        k_row.update({f"level1_full_ms_nq{nq}": ms,
                      f"level1_full_GBps_nq{nq}": db_bytes / ms / 1e6,
                      f"level1_full_bound_ms_nq{nq}": b["bound_ms"],
                      f"level1_full_bound_by_nq{nq}": b["bound_by"],
                      f"level1_full_share_of_bound_nq{nq}": b["bound_ms"] / ms})
    # the whole DB's level 1 against torch._int_mm over the same int8 rows
    # (with their padding) x 8 int8 columns
    rows, stride = eng.db.shape[0], eng.db.stride(0)
    db_whole = torch.as_strided(eng.db, (rows, stride), (stride, 1))
    k_row["level1_full_library_ms"] = cuda_ms(lambda: torch._int_mm(
        db_whole, torch.ones((stride, 8), dtype=torch.int8, device=dev)), 5)
    # K tiled's whole H1 (one launch over the DB @ A1) and one H2 pair
    # launch (digits @ A2) beside the library: torch._int_mm over the same
    # int8 rows x the u32 operand's four byte planes (4n int8 columns), the
    # faster of a row-major and a column-major second operand; for H2 both
    # digit planes stacked (2n rows) over l, padded to 16. Yardsticks only:
    # the port never calls them
    n = eng.params.n

    def int_mm_layouts(a: torch.Tensor) -> dict:
        ones = torch.ones((a.shape[1], 4 * n), dtype=torch.int8, device=dev)
        out = {"row_major": cuda_ms(lambda: torch._int_mm(a, ones), 3)}
        ones = ones.t().contiguous().t()
        out["col_major"] = cuda_ms(lambda: torch._int_mm(a, ones), 3)
        return out

    h1_lib = int_mm_layouts(db_whole)
    del db_whole
    torch.cuda.empty_cache()
    h2_lib = int_mm_layouts(torch.ones((2 * n, -(-eng.params.l // 16) * 16),
                                       dtype=torch.int8, device=dev))
    torch.cuda.empty_cache()
    k_row.update(tiled_h1_full_library_ms=min(h1_lib.values()),
                 tiled_h1_full_library_layouts_ms=h1_lib,
                 tiled_h2_library_ms=min(h2_lib.values()),
                 tiled_h2_library_layouts_ms=h2_lib)
    log(f"[checklist] library yardsticks: the whole H1 as torch._int_mm "
        f"({rows} x {stride} @ {stride} x {4 * n} int8) {h1_lib} ms; one H2 "
        f"pair launch's ({2 * n} x {-(-eng.params.l // 16) * 16} @ ... x "
        f"{4 * n}) {h2_lib} ms")
    # a_2, the narrow form, on the bucket's own operands: every row held
    # against the plain version (512-row bands), nq = 8 and 1
    h_rows = eng.h1_lo.shape[0]
    for nq in (8, 1):
        q = q2[:, :nq].contiguous()
        got = st.dot_i8pair_u32(eng.h1_lo, eng.h1_hi, q)
        for r0 in range(0, h_rows, 512):
            sl = slice(r0, r0 + 512)
            table.check("dp_dot_i8", f"answer a_2 (narrow form), the "
                        f"bucket's hint rows {r0}.., nq={nq}", max_abs_err(
                            got[sl], st._dot_plain(eng.h1_lo[sl],
                                                   eng.h1_hi[sl], q, 0,
                                                   False)))
        b = bound(nbytes(eng.h1_lo, eng.h1_hi, q) + 4 * h_rows * nq,
                  7 * 2 * eng.h1_lo.numel() * 8, INT8_OPS_PER_S)
        k_row.update({f"a2_full_ms_nq{nq}": cuda_ms(
            lambda: st.dot_i8pair_u32(eng.h1_lo, eng.h1_hi, q), 10),
            f"a2_full_bound_ms_nq{nq}": b["bound_ms"],
            f"a2_full_bound_by_nq{nq}": b["bound_by"]})
        del got
    # the library yardstick: torch._int_mm over both planes stacked, (2 x
    # 4,096 rows with their padding) @ (K padded, 32) int8: the four byte
    # planes of 8 columns; the port never calls it
    pstride = eng.h1_lo.stride(0)
    stacked = torch.cat([torch.as_strided(p, (h_rows, pstride), (pstride, 1))
                         for p in (eng.h1_lo, eng.h1_hi)])
    ones = torch.ones((pstride, 32), dtype=torch.int8, device=dev)
    k_row["a2_library_ms"] = cuda_ms(lambda: torch._int_mm(stacked, ones), 10)
    del stacked, ones
    k_row.update(
        a2_blocks_per_sm=_build.lib()["sdk_dp_dot_i8_narrow_occupancy"](1),
        a2_ptxas={k: v for k, v in _build.ptxas_usage("dp_dot_i8").items()
                  if "narrow" in k})
    a2_ms = k_row["a2_full_ms_nq8"]
    out["level1_ms_nq8"] = k_row["level1_full_ms_nq8"]
    out["level1_GBps_nq8"] = k_row["level1_full_GBps_nq8"]
    log(f"[checklist] answer wall median {out['answer_wall_ms_nq8_median']:.2f}"
        f" ms (nq=8), {out['answer_wall_ms_nq1_median']:.2f} ms (nq=1); K "
        f"level 1 over {db_bytes} bytes {out['level1_ms_nq8']:.3f} ms = "
        f"{out['level1_GBps_nq8']:.0f} GB/s; a_2 {a2_ms:.3f} ms (narrow "
        f"form, nq=1 {k_row['a2_full_ms_nq1']:.3f}; torch._int_mm "
        f"{k_row['a2_library_ms']:.3f}); "
        f"{counts['dp_dot_i8']} K + {counts['dp_matmul_u32']} L launches per "
        f"answer")
    del srv, eng, q1, q2
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s) visible, 1 used")

    from sdk_tpu_torch import _build
    from sdk_tpu_torch.params_store import get_params_from_store

    t = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t
    log(f"[build] kernels built in parallel and loaded in {build_s:.1f} s")

    params = get_params_from_store(15, 32768)
    table = KernelTable()
    phase_kernels(params, dev, table)
    log("[kernels] A, A', B, D equal their plain versions at the main "
        "path's shapes")
    phase_fused_kernels(params, dev, table)
    phase_small_configs(dev)
    t = time.perf_counter()
    sessions = Sessions(params)
    log(f"[sessions] 5 client key sets in {time.perf_counter() - t:.1f} s")
    launches = Launches()
    lifecycle = phase_lifecycle(params, sessions, dev, table, launches)
    full, probe = phase_full(params, sessions, dev, table, launches)
    sharded = phase_sharded(params, sessions, dev, table, launches, probe)
    del probe
    ckpt = tempfile.mkdtemp(prefix="load_ckpt_")
    try:
        service = phase_service(params, sessions, dev, launches,
                                keep_dense=ckpt)
        del sessions
        gc.collect()
        torch.cuda.empty_cache()
        load = phase_load(ckpt, card)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    direct = phase_direct(params, dev, launches)
    client_test = phase_client_test(dev)
    phase_doublepir_kernels(dev, table)
    log("[dp kernels] K (one plane, pair, colsum row, row-batch select) and "
        "L (plain, packed) equal their plain versions at the checklist "
        "path's shapes")
    phase_doublepir_small(dev)
    checklist = phase_checklist_full(dev, table, launches)
    phase_device_times(params, dev, table)
    torch.cuda.empty_cache()
    traces = phase_traces()
    multiproc = phase_multiproc()

    for name in _build.LAUNCHES:
        n = launches.total.get(name, 0)
        if n <= 0 and name not in OFF_PATH:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")
        table.rows[name]["launches"] = n
    log("[report] " + json.dumps({"card": card, "build_s": build_s,
                                  "launches": launches.total,
                                  "lifecycle": lifecycle, "full": full,
                                  "sharded": sharded, "service": service,
                                  "load": load, "direct": direct,
                                  "client_test": client_test,
                                  "checklist": checklist,
                                  "traces": traces,
                                  "multiproc": multiproc}))
    log(card)
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
