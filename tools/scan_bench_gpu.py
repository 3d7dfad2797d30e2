#!/usr/bin/env python3
"""Time kernel C (the dense first-dimension scan) or kernel I (the compact
scan) of sdk_tpu_torch on one CUDA card, on a random index of the 1 GiB
bucket's full size; or kernels A / A' (the NTT), F (the fold round) or G
(pack + encode) at the 1 GiB bucket's read-path shapes; or K's tiled form,
the checklist answer's L and K products, M, or the write path's H and H'.

    python3 tools/scan_bench_gpu.py [--kernel dense|compact|ntt|fold|pack|dot
                                              |ingest|migrate|r2g|answer|psum]
                                    [--root DIR] [--sweep] [--iters N]
                                    [--columns 2,32] [--config CHECKLIST]

Builds the kernels of the sdk_tpu_torch package found under ``--root``
(default: this checkout). ``--kernel dense`` (the default) fills an 8.59 GB
dense index (2 channels x 2048 z x 4 limbs x 128 words x 1024 rows) with
random 7-bit limbs from a seed; ``--kernel compact`` fills the compact
indexes of the lifecycle's S1 (cap 8, 134 MB) and S2 (cap 128, 2.15 GB)
states, every slot occupied, each bin's slots on distinct random dim0
columns. Each index is checked against the kernel's plain version on a
z-slice; one JSON line then gives the whole-index time at R = 2 and R = 32
columns (a single read and a 16-query batch; ``--columns`` names others),
its bound (bytes moved, or int8 operations at the tensor-core peak) and
share of it, and the time of ``torch._int_mm`` over the same int8 bytes at
8 and 32 columns (a yardstick the port never calls; its output bytes stand
beside the scan's: over the S1 index at 32 columns it writes 8x fewer). ``--root`` lets
one call time two checkouts in turn, each in its own process (parent,
change, change, parent). ``--sweep`` also times every tiling that
``scan_tiling`` or ``compact_scan_tiling`` offers (a checkout that has
one), and above 64 columns each warp layout of C's resident form
(``resident_scan_tiling``). Each whole-index row names the form and
tiling that ``scan_tiling`` picks, and the line ends with the launches by
kernel.

``--kernel ntt`` times A and A' on (count, 2, 2048) residues at 24 and
6,144 polynomials (the expansion's rounds r = 1 and 9 before kernel E),
8,192, and 65,536 (the 16-batch's fold input), each checked
whole against the plain version, with
CUDA events over back-to-back calls and with the kernel's device time from
torch.profiler (the events carry the wrapper's host time at small counts).
``--kernel fold`` times F on every round of a fold at NQ = 1 and 16 (per-
query keys; round r has 16 NQ 2^(5-r) output slots) and the whole fold,
each round checked against the plain version on every query. ``--kernel
pack`` times the pack + encode stage's kernels at NQ = 1 and 16: G in its
out_words mode, or in a checkout from before it G's raw mode and one D a
query, checked against the plain pack and encode; ``--sweep`` adds G's
device time in each of its forms (``pack_tiling``) at NQ = 1-16. All give the
bounds (bytes at the HBM rate, butterflies at 6 operations at the 32-bit
peak), the build's registers and spills, F's blocks an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor) and, with cuobjdump, the
static SASS instruction counts of the kernels; ``--sweep`` times every
tiling that ``fold_tiling`` offers.

``--kernel dot`` times kernel K's tiled form at the production checklist
config (``--config``): the hint setup's H1 on a 4,224-row sample and on
the whole 8.59 GB DB of random rows from a seed (one launch), one H2
digit-plane pair launch, the schedule's HBM bytes by an analytic model,
and the production setup's wall split and peak memory on the same DB, and
the answer's a_2 shape in the form the answer runs (``bench_dot``). Its
tiling is fixed, so ``--sweep`` adds nothing there.

``--kernel r2g`` times the read path's Regev -> GSW conversion with the
negated folding keys at NQ = 1 and 16 on random canonical leaves of a
dense expansion, each query with its own keyed conversion key: in a
checkout with the regev_to_gsw kernel its one launch (``regev_to_gsw_neg``),
else the chain the engine ran before it (the keys' stack, A', the torch
compose and digits, A, B, the folding-key layout, then
``get_v_folding_neg``: A', Q - x, A, add_mod), each checked against the
chain's plain pieces (present in both), with CUDA events over the stage
and each kernel's profiler device time, beside the byte bound and, at NQ
= 1, the latency bound of one dependent inverse and forward transform
(A' and A on one polynomial pair, device time). ``--kernel answer``
times the checklist answer's msg0 = a_1t @ A2 and h_2 = a_1t @ q2 at the
production config (``--config``), nq = 8 and 1: L's fused answer launch
(``answer_products``) or, before it, two ``mat_mul_vec_packed`` launches,
checked against the plain products, events and device times beside the
bound (A2 + q2 + a_1t read once); then the answer's hint product a_2 at nq
= 8 and 1 on random digit planes of the production shape: K's narrow form,
or in a parent the rows form (``bench_a2``); and the level-1 pass (K's
select form) over a whole random DB of the production shape
(``bench_level1``). ``--kernel psum`` times
kernel M at the sharded read's D = 4 partials (R = 2) and the 16-batch's
(R = 32), and in the wrapping form: events, the kernel's device time and
any copy a call makes, the host time of a call (``bench_psum``).

``--kernel ingest`` times kernel H (the write path's ingest) on a
full-size 8.59 GB dense index: 256 and 1,024 neighbouring items and 256
scattered items, each checked against the plain version on a z-slice,
with CUDA events and each kernel's profiler device time, beside the byte
bound and the sector floor; then the full 32,768-item fill through the bucket server twice (writes, flushes,
peak memory) and the lifecycle's migrating flush (``bench_ingest``,
``bench_fill``). ``--kernel migrate`` times kernel H' (the dense
migration) on random S2 (cap 128) and fill (cap 64) compact indexes,
checked whole against the plain version (``bench_migrate``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)          # this checkout's chip_smoke helpers

from chip_smoke import (BUTTERFLY_OPS, CHECKLIST,  # noqa: E402
                        HBM_BYTES_PER_S, INT8_OPS_PER_S, INT32_OPS_PER_S,
                        cuda_ms, device_ms)

SEED = 20261017
NTT_COUNTS = (24, 6144, 8192, 65536)


def sass_counts(path: str) -> dict:
    """Static SASS instructions of each kernel in a built library, total
    and by opcode, from cuobjdump -sass; empty without cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=False).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"total": 0, "ops": {}}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name:
            op = m.group(1).split(".")[0]
            out[name]["total"] += 1
            out[name]["ops"][op] = out[name]["ops"].get(op, 0) + 1
    return out


def kernel_report(_build, stem: str) -> dict:
    """Registers and spills (ptxas) and SASS counts of csrc/<stem>.cu."""
    rep = {}
    if hasattr(_build, "ptxas_usage"):
        rep["ptxas"] = _build.ptxas_usage(stem)
    rep["sass"] = sass_counts(str(_build.build()[stem]))
    return rep


def bench_ntt(torch, params, dev, gen, args) -> dict:
    """A and A' at the read path's polynomial counts."""
    from sdk_tpu_torch.ops import ntt

    tables = ntt.tables(params, dev)
    out = {}
    for count in NTT_COUNTS:
        x = torch.stack([torch.randint(0, q, (count // 2, params.poly_len),
                                       dtype=torch.int32, device=dev,
                                       generator=gen)
                         for q in params.moduli], dim=1)
        for name, fn, plain in (("forward", ntt.ntt_forward,
                                 ntt.ntt_forward_plain),
                                ("inverse", ntt.ntt_inverse,
                                 ntt.ntt_inverse_plain)):
            if not torch.equal(fn(params, x), plain(params, x)):
                raise AssertionError(f"ntt {name} {count}: kernel != plain")
            torch.cuda.empty_cache()
        moved = 2 * x.numel() * 4 + tables.numel() * 4
        ops = count * params.poly_len // 2 * params.poly_len_log2 * BUTTERFLY_OPS
        bnd = max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        row = {"bound_ms": bnd}
        for name, inv in (("forward", False), ("inverse", True)):
            fn = ntt.ntt_inverse if inv else ntt.ntt_forward
            row[f"{name}_ms"] = cuda_ms(lambda: fn(params, x),
                                        args.iters)
            row[f"{name}_device_ms"] = device_ms(
                lambda: fn(params, x), "ntt_kernel", args.iters)
        out[f"polys{count}"] = row
        del x
    return out


def bench_fold(torch, params, dev, gen, args) -> dict:
    """F on every round at NQ = 1 and 16, and the whole fold."""
    from sdk_tpu_torch.ops import spiral as sj

    it = params.instances * params.n * params.n
    ell = 2 * params.t_gsw
    z = params.poly_len
    out = {}
    for nq in (1, 16):
        keys = [torch.stack([torch.randint(
            0, q, (nq, params.db_dim_2, 2, ell, z), dtype=torch.int32,
            device=dev, generator=gen) for q in params.moduli], dim=-2)
            for _ in range(2)]
        vn, vf = keys
        cts0 = torch.randint(0, params.modulus, (nq, it, 1 << params.db_dim_2,
                                                 2, 1, z), dtype=torch.int64,
                             device=dev, generator=gen)
        cts = cts0
        for r in range(params.db_dim_2):
            key = params.db_dim_2 - 1 - r
            got = sj._fold_round_launch(params, cts, vn, vf, key, 1)
            for q in range(nq):              # plain: a query a time
                if not torch.equal(got[q:q + 1], sj.fold_round_plain(
                        params, cts[q:q + 1], vn[q:q + 1, key],
                        vf[q:q + 1, key])):
                    raise AssertionError(f"fold NQ={nq} round {r} query {q}: "
                                         f"kernel != plain")
            slots = nq * it * cts.shape[2] // 2
            ops = slots * (2 * (2 * ell + 2) * z // 2 * params.poly_len_log2
                           * BUTTERFLY_OPS + 2 * ell * 4 * z * 2)
            moved = cts.numel() * 8 * 3 // 2 + nq * 2 * 2 * ell * 2 * z * 4
            row = {"slots": slots,
                   "bound_ms": max(moved / HBM_BYTES_PER_S,
                                   ops / INT32_OPS_PER_S) * 1e3,
                   "ms": cuda_ms(lambda: sj._fold_round_launch(
                       params, cts, vn, vf, key, 1), args.iters),
                   "device_ms": device_ms(lambda: sj._fold_round_launch(
                       params, cts, vn, vf, key, 1), "fold_round_kernel",
                       args.iters)}
            if args.sweep and hasattr(sj, "fold_tiling"):
                row["tiling"] = sj.fold_tiling(slots, params.t_gsw)._asdict()
                forms = {sj.fold_tiling(slots, params.t_gsw, c)
                         for c in (1, 2, 4)}
                row["sweep_device_ms"] = {
                    "_".join(f"{k}{v}" for k, v in tl._asdict().items()):
                    device_ms(lambda: sj._fold_round_launch(
                        params, cts, vn, vf, key, 1, tl),
                        "fold_round_kernel", args.iters)
                    for tl in sorted(forms)}
            out[f"nq{nq}_round{r}"] = row
            cts = got
        out[f"nq{nq}_whole_fold_ms"] = cuda_ms(
            lambda: sj.fold_ciphertexts(params, cts0, vf, vn),
            args.iters)
        del keys, vn, vf, cts0, cts, got
        torch.cuda.empty_cache()
    return out


def bench_pack(torch, params, dev, gen, args) -> dict:
    """The pack + encode stage's kernels at NQ = 1 and 16 (per-query keys):
    G in its out_words mode, or, in a checkout from before it, G's raw mode
    and one D a query; checked against the plain version, timed with CUDA
    events over the stage and with each kernel's device time. ``--sweep``
    adds NQ = 2, 4, 8 and 12 and G's device time in each of its forms (one
    block, or a cluster of n blocks, a (query, instance, column)), each
    checked."""
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan

    n, z, inst = params.n, params.poly_len, params.instances
    plan = ResponseEncodePlan(params, dev)
    fused = hasattr(sj, "pack_encode")
    out = {"fused": fused}
    for nq in (1, 2, 4, 8, 12, 16) if fused and args.sweep else (1, 16):
        keys = [[torch.stack([torch.randint(
            0, q, (n + 1, params.t_conv, z), dtype=torch.int32, device=dev,
            generator=gen) for q in params.moduli], dim=-2)
            for _ in range(2 if params.version else n)] for _ in range(nq)]
        v_ct = torch.randint(0, params.modulus, (nq, inst, n * n, 2, 1, z),
                             dtype=torch.int64, device=dev, generator=gen)
        if fused:
            def stage():
                return sj.pack_encode(params, v_ct, keys, plan)
        else:
            def stage():
                packed = sj.pack_queries(params, v_ct, keys, raw=True)
                return torch.stack([plan.encode(p) for p in packed])
        want = torch.stack([plan.encode_plain(p) for p in sj._from_ntt_plain(
            params, torch.stack([torch.stack([
                sj.pack_plain(params, v_ct[i, j], keys[i])
                for j in range(inst)]) for i in range(nq)]))])
        if not torch.equal(stage(), want):
            raise AssertionError(f"pack + encode NQ={nq}: kernel != plain")
        row = {"ms": cuda_ms(stage, args.iters),
               "pack_device_ms": device_ms(stage, "pack_kernel", args.iters),
               "encode_device_ms": device_ms(stage, "encode_kernel",
                                             args.iters)}
        if fused:
            row["tiling"] = sj.pack_tiling(params, nq,
                                           sj._sm_count(dev))._asdict()
        if fused and args.sweep:
            row["sweep_device_ms"] = {}
            for cluster in (1, n):
                def form():
                    return sj._pack_launch(params, v_ct, keys, "words", plan,
                                           cluster)
                if not torch.equal(form(), want):
                    raise AssertionError(f"pack NQ={nq} cluster {cluster}: "
                                         f"kernel != plain")
                row["sweep_device_ms"][f"cluster{cluster}"] = device_ms(
                    form, "pack_kernel", args.iters)
        out[f"nq{nq}"] = row
        del keys, v_ct, want
    return out


def bench_dot(torch, dev, gen, args) -> dict:
    """Kernel K's tiled form (the checklist hint setup's products) at the
    production config: H1 on a 4,224-row sample of the DB and on the whole
    8.59 GB DB of random rows (one launch), one H2 digit-plane pair launch,
    each checked against the plain version on row slices (the whole H1's
    first and last rows) and timed with CUDA events with the setup's add
    row and without it (c = 0); the analytic HBM bytes of the schedule;
    the production setup's wall and peak memory on the same DB, then the
    same setup again split (chip_smoke.setup_split); and the answer's a_2
    shape (4,096 digit rows @ 8 columns) in the form the answer runs."""
    import numpy as np
    from chip_smoke import dev_i8, dev_u32, setup_split, tiled_hbm_bytes
    from sdk_tpu_torch.doublepir import server_torch as st
    from sdk_tpu_torch.doublepir.params import Params

    params = Params.from_string(args.config)
    l, m, n, p = params.l, params.m, params.n, params.p
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cores = hasattr(st, "_dot_tiled_launch")
    bm, bn = (64, 128) if cores else (128, 128)
    out = {"tensor_cores": cores, "tiling": {"bm": bm, "bn": bn}}

    def check(label, got, lo, hi, b, c):
        want = st._dot_plain(lo, hi, b, c, False)
        if not torch.equal(got, want):
            raise AssertionError(f"dot {label}: kernel != plain")

    def case(label, lo, hi, b, c, products):
        M, K = lo.shape
        N = b.shape[1]
        pair = hi is not None
        fn = st.dot_i8pair_u32 if pair else st.dot_i8_u32
        args_ = (lo, hi) if pair else (lo,)
        iters = 2 if M > 8192 else args.iters
        moved = M * K * (1 + pair) + K * N * 4 + M * N * 4
        row = {"shape": [M, K, N], "pair": pair,
               "ms": cuda_ms(lambda: fn(*args_, b, c=c), iters),
               "ms_c0": cuda_ms(lambda: fn(*args_, b), iters),
               "int8_bound_ms": max(moved / HBM_BYTES_PER_S, products * 2 * M
                                    * K * N / INT8_OPS_PER_S) * 1e3,
               "int32_bound_ms": max(moved / HBM_BYTES_PER_S, 2 * M * K * N
                                     / INT32_OPS_PER_S) * 1e3,
               "analytic_hbm_bytes": tiled_hbm_bytes(M, K, N, bm, bn, sms,
                                                     pair),
               "bytes_once": moved}
        row["int8_share"] = row["int8_bound_ms"] / row["ms_c0"]
        out[label] = row
        return row

    # the production DB of random rows, in the engine's own aligned rows
    srv = st.ChecklistServerTorch(l * m * 8, params, np.zeros(1, np.uint8),
                                  device=dev)
    db = srv.db
    for r0 in range(0, l, 4096):
        r1 = min(l, r0 + 4096)
        db[r0:r1].copy_(torch.randint(-128, 128, (r1 - r0, m),
                                      dtype=torch.int8, device=dev,
                                      generator=gen))
    a1 = dev_u32(gen, (m, n), dev)
    c1 = 128 - p // 2
    rows = db[:min(l, 33 * 128)]
    check("sample", st.dot_i8_u32(rows[:128], a1, c=c1), rows[:128], None,
          a1, c1)
    case("sample", rows, None, a1, c1, 4)
    h1 = st.dot_i8_u32(db, a1, c=c1)
    for sl in (slice(0, 128), slice(l - 97, l)):
        check("whole H1", h1[sl], db[sl], None, a1, c1)
    del h1
    case("whole_h1", db, None, a1, c1, 4)
    a2 = dev_u32(gen, (l, n), dev)
    lo, hi = dev_i8(gen, (n, l), dev, 0, 128), dev_i8(gen, (n, l), dev, 0, 4)
    check("h2 pair", st.dot_i8pair_u32(lo[:128], hi[:128], a2, c=-(p // 2)),
          lo[:128], hi[:128], a2, -(p // 2))
    case("h2_pair", lo, hi, a2, -(p // 2), 7)
    # the answer's a_2: (n delta, l rounded up to 3) digit planes @ 8, in
    # the form the answer runs (the narrow form; the rows form before it)
    l3 = -(-l // 3) * 3
    d_lo = dev_i8(gen, (n * params.delta(), l3), dev, 0, 128)
    d_hi = dev_i8(gen, (n * params.delta(), l3), dev, 0, 4)
    q2 = dev_u32(gen, (l3, 8), dev)
    check("a_2", st.dot_i8pair_u32(d_lo[:256], d_hi[:256], q2), d_lo[:256],
          d_hi[:256], q2, 0)
    out["answer_a2"] = {
        "shape": [n * params.delta(), l3, 8],
        "form": "narrow" if hasattr(st, "_dot_narrow_launch") else "rows",
        "ms": cuda_ms(lambda: st.dot_i8pair_u32(d_lo, d_hi, q2), args.iters)}
    del d_lo, d_hi, q2
    del a1, a2, lo, hi, rows
    torch.cuda.empty_cache()

    # the production setup on the same DB: the AES-derived A1 / A2, as a
    # user meets it (its wall and peak), then again split into its parts
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    srv.setup_streamed()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev)
    t = time.perf_counter()
    with setup_split(st) as split:
        srv.setup_streamed()
    split["wall_s"] = time.perf_counter() - t
    out["setup"] = {"wall_s": wall, "split": split,
                    "allocated_before": before, "max_memory_allocated": peak}
    del srv, db
    torch.cuda.empty_cache()
    return out


def bench_ingest(torch, sj, params, dev, gen, args) -> dict:
    """Kernel H at the 1 GiB bucket's write-path shapes, on a full-size
    8.59 GB dense index of random limbs: 256 and 1,024 neighbouring items
    (whole sectors: a bulk load's flush chunk) and 256 scattered items, each
    checked against the plain version on a z-slice of the index and timed
    with CUDA events and (last) torch.profiler device times; the bounds
    (bytes; the scattered items' sector floor: every sector they touch read
    and written whole); then the full 32,768-item fill through the bucket
    server (bench_fill)."""
    import numpy as np
    from sdk_tpu_torch.kv import ingest as ing

    it = params.instances * params.n * params.n
    z, npr = params.poly_len, 1 << params.db_dim_2
    db = torch.randint(0, 128, sj.db_shape(params), dtype=torch.int8,
                       device=dev, generator=gen)
    rng = np.random.default_rng(SEED)
    raw = torch.from_numpy(rng.integers(
        0, 256, (1024, it, params.bytes_per_chunk()), dtype=np.uint8)).to(dev)
    cases = {"neighbouring_256": np.arange(512, 768),
             "neighbouring_1024": np.arange(1024, 2048),
             "scattered_256": np.sort(rng.choice(params.num_items(), 256,
                                                 replace=False))}
    sectors = it * 2 * z * 4
    out, calls = {}, {}
    for name, idxs in cases.items():
        K = len(idxs)
        bins, cols = idxs % npr, idxs // npr
        rb = raw[:K]
        zs = 64
        before = db[:, :zs].clone()
        ing.ingest_into(params, db, bins, cols, rb)
        want = before
        sj.db_write_items(params, want, bins, cols,
                          ing.ingest_plain(params, rb)[..., :zs].contiguous())
        if not torch.equal(db[:, :zs], want):
            raise AssertionError(f"ingest {name}: kernel != plain")
        del before, want
        fn = (lambda b=bins, c=cols, r=rb: ing.ingest_into(params, db, b, c, r))
        calls[name] = fn
        moved = K * it * params.bytes_per_chunk() + K * it * 2 * z * 4 + 16 * K
        row = {"items": K, "ms": cuda_ms(fn, args.iters),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        # every touched sector stored whole, a partial one read first
        groups = np.unique((cols // 4) * (npr // 8) + bins // 8)
        full = sum(1 for g in groups
                   if np.sum((cols // 4) * (npr // 8) + bins // 8 == g) == 32)
        row["sector_floor_ms"] = (K * it * params.bytes_per_chunk() + sectors
                                  * 32 * (full + 2 * (len(groups) - full))
                                  ) / HBM_BYTES_PER_S * 1e3
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        out[name] = row
    if hasattr(ing, "INGEST_BATCH_ITEMS"):
        out["batch_items"] = ing.INGEST_BATCH_ITEMS
    out["plain_ms_neighbouring_256"] = cuda_ms(
        lambda: sj.db_write_items(params, db, cases["neighbouring_256"] % npr,
                                  cases["neighbouring_256"] // npr,
                                  ing.ingest_plain(params, raw[:256])), 2)
    del db
    torch.cuda.empty_cache()
    out["fill"] = bench_fill(torch, sj, params, dev)
    # profiler times last: a session slows the process's later launches
    db = torch.zeros(sj.db_shape(params), dtype=torch.int8, device=dev)
    for name, idxs in cases.items():
        bins, cols = idxs % npr, idxs // npr
        out[name]["device_ms_by_kernel"] = device_split(
            torch, lambda b=bins, c=cols, r=raw[:len(idxs)]: ing.ingest_into(
                params, db, b, c, r), args.iters)
        out[name]["device_ms"] = sum(out[name]["device_ms_by_kernel"].values())
    del db, raw
    torch.cuda.empty_cache()
    return out


def bench_r2g(torch, params, dev, gen, args) -> dict:
    """The Regev -> GSW conversion and the negated folding keys of a batch
    at NQ = 1 and 16: the regev_to_gsw kernel, or the parent's chain."""
    import numpy as np

    from sdk_tpu_torch import poly as hpoly
    from sdk_tpu_torch.ops import ntt
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.modops import add_mod, shoup_companion_arr, u32_bits

    fused = hasattr(sj, "regev_to_gsw_neg")
    n, T, D = params.poly_len, params.t_gsw, params.db_dim_2
    n_gsw, tc2 = T * D, 2 * params.t_conv
    gadget = u32_bits(hpoly.to_ntt(params, hpoly.build_gadget(
        params, 2, 2 * T)), dev)
    one = torch.stack([torch.randint(0, q, (1, n), dtype=torch.int32,
                                     device=dev, generator=gen)
                       for q in params.moduli], dim=1)
    a_inv = device_ms(lambda: ntt.ntt_inverse(params, one), "ntt_kernel",
                      args.iters)
    a_fwd = device_ms(lambda: ntt.ntt_forward(params, one), "ntt_kernel",
                      args.iters)

    def chain_plain(v_gsw, w):
        raw = sj._from_ntt_plain(params, v_gsw)
        conv = sj.matmul_mod_plain(params, w, sj._to_ntt_plain(
            params, sj.gadget_digits(params, raw, tc2, 2)))
        vf = torch.stack([conv, v_gsw], dim=-5).reshape(
            v_gsw.shape[:-5] + (D, 2 * T, 2, 2, n)).transpose(-4, -3)
        inv = sj._to_ntt_plain(params, sj.invert_raw_pair(
            params, sj._from_ntt_plain(params, vf)))
        return vf.contiguous(), add_mod(params, gadget[None], inv)

    out = {"fused": fused, "a_inverse_one_pair_device_ms": a_inv,
           "a_forward_one_pair_device_ms": a_fwd}
    for nq in (1, 16):
        leaves = torch.stack([torch.randint(
            0, q, (nq, 2 * n_gsw, 2, 1, n), dtype=torch.int32, device=dev,
            generator=gen) for q in params.moduli], dim=-2)
        pps = []
        for _ in range(nq):
            w = torch.stack([torch.randint(0, q, (2, tc2, n),
                                           dtype=torch.int32, device=dev,
                                           generator=gen)
                             for q in params.moduli], dim=-2)
            ws = u32_bits(shoup_companion_arr(
                params, w.cpu().numpy().astype(np.uint64)), dev)
            pps.append({"v_exp_left": [], "v_exp_right": [],
                        "v_conversion": (w, ws)})
        want = chain_plain(leaves[:, 1::2], torch.stack(
            [pp["v_conversion"][0] for pp in pps]))
        if fused:
            keys = sj.ExpansionKeys(params, pps)
            pos = torch.arange(1, 2 * n_gsw, 2, dtype=torch.int32,
                               device=dev)

            def stage():
                return sj.regev_to_gsw_neg(params, leaves, pos, keys, gadget)
        else:
            def stage():
                v_gsw = leaves[:, 1::2][:, :n_gsw]
                v_conv = tuple(torch.stack(k) for k in zip(
                    *(pp["v_conversion"] for pp in pps)))
                vf = sj.regev_to_gsw(params, v_gsw, v_conv)
                return vf, sj.get_v_folding_neg(params, vf, gadget)
        got = stage()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"regev_to_gsw NQ={nq}: kernel != plain")
        moved = (leaves[:, 1::2].numel() * 4 + nq * 2 * 2 * tc2 * 2 * n * 4
                 + gadget.numel() * 4 + 2 * want[0].numel() * 4)
        ops = nq * n_gsw * (4 + 2 * tc2) * (n // 2) * 11 * BUTTERFLY_OPS
        bnd = max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        split = device_split(torch, stage, args.iters)
        row = {"ms": cuda_ms(stage, args.iters), "device_split_ms": split,
               "device_ms": sum(split.values()), "bound_ms": bnd,
               "bytes": moved, "bound_by": "bytes" if moved / HBM_BYTES_PER_S
               >= ops / INT32_OPS_PER_S else "operations"}
        if nq == 1 and a_inv and a_fwd:
            row["latency_bound_ms"] = a_inv + a_fwd
        if fused:                    # configuration, not measured
            row["cluster"] = sj.regev_to_gsw_tiling(
                nq * n_gsw, sj._sm_count(dev))
        out[f"nq{nq}"] = row
        del leaves, pps, want, got
    return out


def bench_answer(torch, dev, gen, args) -> dict:
    """The checklist answer's msg0 and h_2 at nq = 8 and 1: L's fused
    answer launch, or the parent's two packed launches."""
    from sdk_tpu_torch.doublepir import kernels as dk
    from sdk_tpu_torch.doublepir.params import Params

    dp = Params.from_string(args.config)
    l3 = -(-dp.l // 3) * 3
    delta = dp.delta()
    fused = hasattr(dk, "answer_products")

    def u32(shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)

    a2 = u32((l3, dp.n))
    a_1t = u32((delta, l3 // 3)) & 0x3FFFFFFF
    out = {"fused": fused, "delta": delta, "K": l3, "N": dp.n}
    for nq in (8, 1):
        q2 = u32((l3, nq))
        if fused:
            def stage():
                return dk.answer_products(a_1t, a2, q2)
        else:
            def stage():
                return (dk.mat_mul_vec_packed(a_1t, a2),
                        dk.mat_mul_vec_packed(a_1t, q2))
        want = (dk.matmul_u32_packed_plain(a_1t, a2),
                dk.matmul_u32_packed_plain(a_1t, q2))
        got = stage()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"answer products nq={nq}: kernel != plain")
        moved = (a2.numel() + q2.numel() + a_1t.numel()
                 + delta * (dp.n + nq)) * 4
        ops = 2 * delta * l3 * (dp.n + nq)
        bnd = max(moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
        split = device_split(torch, stage, args.iters)
        dev_ms = sum(v for k, v in split.items()
                     if "matmul_u32" in k or "answer" in k)
        out[f"nq{nq}"] = {"ms": cuda_ms(stage, args.iters),
                          "device_split_ms": split, "device_ms": dev_ms,
                          "stage_device_ms": sum(split.values()),
                          "bound_ms": bnd, "share_of_bound": bnd / dev_ms
                          if dev_ms else None}
        del q2, want, got
    from sdk_tpu_torch import _build

    fn = _build.lib().get("sdk_dp_answer_blocks")
    out["answer_blocks"] = fn() if fn is not None else None
    out["a_2"] = bench_a2(torch, dp, dev, gen, args)
    out["level1"] = bench_level1(torch, dp, dev, gen, args)
    return out


def bench_level1(torch, dp, dev, gen, args) -> dict:
    """The answer's level-1 pass, K's select form, over a whole random DB of
    the production shape (l x m int8 in aligned rows) at nq = 8 and 1,
    checked against the plain version on the first and last 64 rows:
    events and profiler device time beside the byte bound."""
    from sdk_tpu_torch.doublepir import server_torch as st

    db = st.aligned_rows(dp.l, dp.m, dev)
    for r0 in range(0, dp.l, 4096):
        r1 = min(dp.l, r0 + 4096)
        db[r0:r1].copy_(torch.randint(-128, 128, (r1 - r0, dp.m),
                                      dtype=torch.int8, device=dev,
                                      generator=gen))
    out = {"shape": [dp.l, dp.m]}
    for nq in (8, 1):
        q1 = torch.randint(-(1 << 31), 1 << 31, (dp.m, nq), dtype=torch.int64,
                           device=dev, generator=gen).to(torch.int32)
        got = st.dot_i8_select(db, q1, c=128)
        idx = st.batch_index(dp.l, nq, dev)
        for sl in (slice(0, 64), slice(max(0, dp.l - 64), dp.l)):
            want = st._dot_plain(db[sl], None, q1, 128, False)
            rows = torch.arange(want.shape[0], device=dev)
            if not torch.equal(got[sl], want[rows, idx[sl]]):
                raise AssertionError(f"level 1 nq={nq}: kernel != plain")

        def stage():
            return st.dot_i8_select(db, q1, c=128)
        ms = cuda_ms(stage, 5)
        split = device_split(torch, stage, 5)
        dev_ms = sum(v for k, v in split.items() if "dot_i8" in k)
        bnd = (dp.l * dp.m + 4 * dp.m * nq + 4 * dp.l) / HBM_BYTES_PER_S * 1e3
        out[f"nq{nq}"] = {"ms": ms, "device_ms": dev_ms, "bound_ms": bnd,
                          "GBps": dp.l * dp.m / dev_ms / 1e6 if dev_ms
                          else None}
        del q1, got
    del db
    torch.cuda.empty_cache()
    return out


def bench_a2(torch, dp, dev, gen, args) -> dict:
    """The answer's hint product a_2 = (h1_lo + h1_hi 2^7) @ q2 at nq = 8
    and 1 (kernel K: the narrow form, or the rows form before it) on random
    digit planes of the production shape, (n delta, l rounded up to 3) in
    aligned rows, checked against the plain version on the first and last
    256 rows; events over back-to-back calls and the kernel's profiler
    device time, beside the bound: both planes, q2 and the output once, or
    7 int8 products a (row, k, column), whichever is longer."""
    from chip_smoke import dev_i8
    from sdk_tpu_torch.doublepir import server_torch as st

    rows, l3 = dp.n * dp.delta(), -(-dp.l // 3) * 3
    lo = dev_i8(gen, (rows, l3), dev, 0, 128)
    hi = dev_i8(gen, (rows, l3), dev, 0, 4)
    out = {"shape": [rows, l3],
           "form": "narrow" if hasattr(st, "_dot_narrow_launch") else "rows"}
    for nq in (8, 1):
        q2 = torch.randint(-(1 << 31), 1 << 31, (l3, nq), dtype=torch.int64,
                           device=dev, generator=gen).to(torch.int32)
        got = st.dot_i8pair_u32(lo, hi, q2)
        for sl in (slice(0, 256), slice(rows - 256, rows)):
            if not torch.equal(got[sl], st._dot_plain(lo[sl], hi[sl], q2, 0,
                                                      False)):
                raise AssertionError(f"a_2 nq={nq}: kernel != plain")
        moved = 2 * rows * l3 + 4 * l3 * nq + 4 * rows * nq
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 7 * 2 * rows * l3 * 8 / INT8_OPS_PER_S * 1e3
        bnd = max(t_bytes, t_ops)

        def stage():
            return st.dot_i8pair_u32(lo, hi, q2)
        ms = cuda_ms(stage, args.iters)
        split = device_split(torch, stage, args.iters)
        dev_ms = sum(v for k, v in split.items() if "dot_i8" in k)
        out[f"nq{nq}"] = {"ms": ms,
                          "device_split_ms": split, "device_ms": dev_ms,
                          "bound_ms": bnd,
                          "bound_by": "bytes" if t_bytes >= t_ops
                          else "operations",
                          "share_of_bound": bnd / dev_ms if dev_ms else None}
        del q2, got
    return out


def bench_psum(torch, params, dev, gen, args) -> dict:
    """Kernel M at the sharded read's shapes: D = 4 partials of a (dp=2,
    db=4) mesh, (2, z, inst, trials / 2, num_per, R) int32, in the Spiral
    form at R = 2 (a read) and R = 32 (a 16-batch), and in the wrapping
    form (q = 0) at R = 2, each checked against the plain version. For each:
    events over back-to-back calls, the profiler's device time of the
    kernel and of any copy or memset the call makes (the parent's pointer
    table is a host-to-device copy), the host time of a call (the wall of
    200 enqueued calls before a synchronize), the byte bound, and
    torch.stack(parts).sum(0) % q."""
    import time

    from sdk_tpu_torch.ops.shard import psum_mod, psum_mod_plain

    z, inst, npr = params.poly_len, params.instances, 1 << params.db_dim_2
    trials = params.n * params.n
    qcol = torch.tensor(params.moduli, dtype=torch.int64,
                        device=dev).reshape(2, 1, 1, 1, 1, 1)
    out = {}
    for label, R, form in (("read", 2, "spiral"), ("batch", 32, "spiral"),
                           ("read_wrapping", 2, "wrapping")):
        shape = (2, z, inst, trials // 2, npr, R)
        if form == "spiral":
            parts = [torch.randint(0, min(params.moduli), shape,
                                   generator=gen, dtype=torch.int32,
                                   device=dev) for _ in range(4)]
            q = params.moduli
            lib = lambda: torch.stack(parts).sum(0) % qcol  # noqa: E731
        else:
            parts = [torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                   dtype=torch.int32, device=dev)
                     for _ in range(4)]
            q = 0
            lib = lambda: torch.stack(parts).sum(0) & 0xFFFFFFFF  # noqa: E731
        if not torch.equal(psum_mod(parts, q), psum_mod_plain(parts, q)):
            raise AssertionError(f"psum_mod {label}: kernel != plain")

        def call():
            return psum_mod(parts, q)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            call()
        host_ms = (time.perf_counter() - t) / 200 * 1e3
        torch.cuda.synchronize()
        moved = 5 * parts[0].numel() * 4
        row = {"shape": list(shape), "D": 4,
               "ms": cuda_ms(call, 20), "host_ms": host_ms,
               "plain_ms": cuda_ms(lambda: psum_mod_plain(parts, q), 3),
               "library_ms": cuda_ms(lib, 5),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
        out[label] = row
        del parts
    # profiler times last: a session slows every later launch
    for label, R, form in (("read", 2, "spiral"), ("batch", 32, "spiral"),
                           ("read_wrapping", 2, "wrapping")):
        shape = (2, z, inst, trials // 2, npr, R)
        parts = [torch.randint(0, min(params.moduli), shape, generator=gen,
                               dtype=torch.int32, device=dev)
                 for _ in range(4)]
        q = params.moduli if form == "spiral" else 0
        split = device_split(torch, lambda: psum_mod(parts, q), 20,
                             copies=True)
        row = out[label]
        row["device_split_ms"] = split
        row["device_ms"] = sum(v for k, v in split.items() if "psum" in k)
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"] \
            if row["device_ms"] else None
        del parts
    return out


def device_split(torch, fn, iters: int, copies: bool = False) -> dict:
    """Mean device ms a call of fn() of each CUDA kernel it launches, by
    kernel name, from torch.profiler; with ``copies`` its memory copies and
    memsets too."""
    import re
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        if us and (copies or not e.key.startswith(("Memcpy", "Memset"))):
            m = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            name = (m.group(1) + (m.group(2) or "")) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + us / iters / 1e3
    return out


def bench_fill(torch, sj, params, dev, repeats: int = 2) -> dict:
    """The full bucket's fill as chip_smoke's phase_full makes it: 32,768
    random 32 KiB rows (made first, not timed) through the bucket server, a
    flush every 4,096 (the first stays compact at cap 64, the second
    migrates through H'), ``repeats`` times on a new bucket each: the wall
    of the writes and flushes, each flush's wall, the launches and the peak
    device memory. Then the lifecycle's migrating flush: 3,500 random items
    flushed into a new bucket, 700 more flushed (it migrates), each flush's
    wall."""
    import numpy as np
    from chip_smoke import random_rows
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    gen = np.random.default_rng(SEED + 1)
    n = params.num_items()
    step = n // 8
    rows = random_rows(params, gen, range(n))
    out = {"wall_s": [], "flush_s": [], "max_memory_allocated": []}
    for _ in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        srv = SpiralKvServerTorch(params, device=dev)
        flush_s, layouts = [], []
        for s in range(0, n, step):
            for i in range(s, s + step):
                srv.update_item_raw(i, rows[i])
            t = time.perf_counter()
            srv.flush()
            torch.cuda.synchronize()
            flush_s.append(time.perf_counter() - t)
            layouts.append("compact" if isinstance(srv.engine.db,
                                                   sj.CompactDb) else "dense")
        out["wall_s"].append(time.perf_counter() - t0)
        out["flush_s"].append(flush_s)
        out["max_memory_allocated"].append(
            torch.cuda.max_memory_allocated(dev))
        out["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
        if layouts[:2] != ["compact", "dense"]:
            raise AssertionError(f"fill: want compact then dense, got "
                                 f"{layouts}")
        del srv
    torch.cuda.empty_cache()
    # the lifecycle's S3 step: 3,500 random items (compact, cap 128), then
    # 700 more, whose flush migrates the bucket
    srv = SpiralKvServerTorch(params, device=dev)
    items = gen.permutation(n)[:4200]
    for part in (items[:3500], items[3500:]):
        for i in sorted(part.tolist()):
            srv.update_item_raw(i, rows[i])
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv.flush()
        torch.cuda.synchronize()
        out.setdefault("s2_s3_flush_s", []).append(time.perf_counter() - t)
    if isinstance(srv.engine.db, sj.CompactDb):
        raise AssertionError("S3: the bucket did not migrate")
    del srv, rows
    torch.cuda.empty_cache()
    return out


def bench_migrate(torch, sj, params, dev, gen, args) -> dict:
    """Kernel H' on random compact indexes of the 1 GiB bucket: the S2
    state (cap 128, 3,500 items over the 64 bins at random) and the fill's
    (cap 64, 4,096 items: 64 a bin), every bin's slots on distinct random
    dim0 columns and the unoccupied slots full of random bytes; each checked
    whole against the plain version and timed with CUDA events; in a
    checkout with the tiled form, its tile and (analytic, not measured) the
    slot-word bytes it stages."""
    import numpy as np
    from chip_smoke import max_abs_err_int8
    from sdk_tpu_torch.kv import ingest as ing

    npr, dim0 = 1 << params.db_dim_2, 1 << params.db_dim_1
    rng = np.random.default_rng(SEED + 2)
    out = {}
    for name, cap, items in (("S2", 128, 3500), ("fill", 64, 4096)):
        planes = torch.randint(-128, 128, sj.compact_shape(params, cap),
                               dtype=torch.int8, device=dev, generator=gen)
        idx_j = torch.stack([torch.randperm(dim0, device=dev,
                                            generator=gen)[:cap]
                             for _ in range(npr)]).to(torch.int32)
        counts = (np.bincount(rng.integers(0, npr, items), minlength=npr)
                  if items < npr * cap else np.full(npr, cap))
        counts = np.minimum(counts, cap)
        db = sj.CompactDb(planes, idx_j)
        got = ing.compact_to_dense(params, db, counts)
        want = ing.compact_to_dense_plain(params, db, counts)
        err = max_abs_err_int8(got, want)
        if err:
            raise AssertionError(f"compact_to_dense {name}: kernel != plain")
        dense_bytes = got.numel()
        del got, want
        occupied = int(counts.sum())
        crt, z, L, cw, inst, trials, _, _ = planes.shape
        moved = (dense_bytes + occupied * crt * z * L * inst * trials
                 + idx_j.numel() * 4 + 4 * npr)
        row = {"cap": cap, "occupied_slots": occupied,
               "max_count": int(counts.max()),
               "ms": cuda_ms(lambda: ing.compact_to_dense(params, db, counts),
                             args.iters),
               "plain_ms": cuda_ms(lambda: ing.compact_to_dense_plain(
                   params, db, counts), 1),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "dense_bytes": dense_bytes}
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["dense_GBps"] = dense_bytes / row["ms"] / 1e6
        if hasattr(ing, "migrate_tiling"):
            tl = ing.migrate_tiling(cw, dim0 // 4, inst * trials, npr,
                                    int(counts.max()))
            row["tiling"] = tl._asdict()
            row["staged_plane_bytes_analytic"] = crt * z * L * tl.cw_used \
                * 4 * inst * trials * npr
        out[name] = row
        del planes, idx_j, db
        torch.cuda.empty_cache()
    return out


def int_mm_ms(torch, planes, cols: int, iters: int) -> float:
    a = planes.view(-1, 256)
    b = torch.ones((256, cols), dtype=torch.int8, device=planes.device)
    return cuda_ms(lambda: torch._int_mm(a, b), iters)


def bench_compact(torch, sj, params, dev, gen, cap: int, args) -> dict:
    """Kernel I on a full-size compact index of cap slots a bin."""
    planes = torch.randint(0, 128, sj.compact_shape(params, cap),
                           dtype=torch.int8, device=dev, generator=gen)
    crt, z, L, cw, inst, trials, npr, _ = planes.shape
    dim0 = 1 << params.db_dim_1
    idx_j = torch.stack([torch.randperm(dim0, device=dev, generator=gen)[:cap]
                         for _ in range(npr)]).to(torch.int32)
    db = sj.CompactDb(planes, idx_j)
    M = inst * trials * npr
    index_bytes = planes.numel()
    row = {"cap": cap, "index_bytes": index_bytes}
    for R in map(int, args.columns.split(",")):
        q_arr = torch.stack([torch.randint(0, q, (z, dim0, R),
                                           dtype=torch.int32, device=dev,
                                           generator=gen)
                             for q in params.moduli])
        zs = 16
        sl = sj.CompactDb(planes[:, :zs].contiguous(), idx_j)
        q_sl = q_arr[:, :zs].contiguous()
        err = int((sj.firstdim_multiply(params, sl, q_sl).long()
                   - sj.firstdim_multiply_compact_plain(params, sl, q_sl)
                   .long()).abs().max())
        if err:
            raise AssertionError(f"cap {cap} R={R}: kernel != plain (max abs "
                                 f"err {err})")
        ms = cuda_ms(lambda: sj.firstdim_multiply(params, db, q_arr),
                     args.iters)
        out_bytes = crt * z * M * R * 4
        moved = index_bytes + idx_j.numel() * 4 + q_arr.numel() * 4 + out_bytes
        bnd = max(moved / HBM_BYTES_PER_S,
                  2 * index_bytes * 4 * R / INT8_OPS_PER_S) * 1e3
        r = {"ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
             "GBps": index_bytes / ms / 1e6, "out_bytes": out_bytes}
        for cols in (8, 32):
            r[f"int_mm_ms_{cols}"] = int_mm_ms(torch, planes, cols, args.iters)
            r[f"int_mm_out_bytes_{cols}"] = index_bytes // 256 * cols * 4
        if args.sweep and hasattr(sj, "compact_scan_tiling"):
            sweep = {}
            default = sj.compact_scan_tiling(R, npr, dim0, cap)
            forms = {default}
            for ntw in (1, 2, 4):
                for gpb in (1, 2, 4, 8):
                    forms.add(sj.compact_scan_tiling(R, npr, dim0, cap,
                                                     ntw=ntw, gpb=gpb))
            for ns in (2, 3):
                forms.add(default._replace(ns=ns))
            forms.add(default._replace(vec=0))
            forms.add(sj.compact_scan_tiling(R, npr, dim0, cap, sw=8))
            for tl in sorted(forms):
                key = (f"ntw{tl.ntw}_rb{tl.rb}_gpb{tl.gpb}_ns{tl.ns}"
                       f"_vec{tl.vec}_sw{tl.sw}")
                sweep[key] = cuda_ms(lambda: sj._scan_compact_launch(
                    params, db, q_arr, tl), args.iters)
            r["sweep_ms"] = sweep
            r["tiling"] = default._asdict()
        row[f"R{R}"] = r
        del q_arr, q_sl
    del planes, db
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--columns", default="2,32")
    ap.add_argument("--config", default=CHECKLIST,
                    help="the checklist config of --kernel dot")
    ap.add_argument("--kernel", default="dense",
                    help="dense, compact, dot, ingest, migrate, r2g, "
                         "answer, psum, or a list of ntt, fold, pack")
    args = ap.parse_args()
    kernels = args.kernel.split(",")
    if not (kernels in (["dense"], ["compact"], ["dot"], ["ingest"],
                        ["migrate"], ["r2g"], ["answer"], ["psum"])
            or set(kernels) <= {"ntt", "fold", "pack"}):
        ap.error(f"--kernel {args.kernel}")
    import torch

    if not torch.cuda.is_available():
        print("scan_bench_gpu: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params_store import get_params_from_store

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.lib()
    params = get_params_from_store(15, 32768)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    if kernels in (["ingest"], ["migrate"]):
        stem = {"ingest": "ingest", "migrate": "compact_to_dense"}[args.kernel]
        bench = {"ingest": bench_ingest, "migrate": bench_migrate}[args.kernel]
        out = {"card": card, "root": os.path.abspath(args.root),
               args.kernel: bench(torch, sj, params, dev, gen, args)}
        out[args.kernel].update(kernel_report(_build, stem))
        print(json.dumps(out))
        return 0
    if kernels == ["r2g"]:
        out = {"card": card, "root": os.path.abspath(args.root),
               "r2g": bench_r2g(torch, params, dev, gen, args)}
        stem = "regev_to_gsw" if out["r2g"]["fused"] else "matmul_mod"
        out["r2g"].update(kernel_report(_build, stem))
        occ = _build.lib().get("sdk_regev_to_gsw_occupancy")
        if occ is not None:
            out["r2g"]["blocks_per_sm"] = occ()
        print(json.dumps(out))
        return 0
    if kernels == ["psum"]:
        out = {"card": card, "root": os.path.abspath(args.root),
               "psum": bench_psum(torch, params, dev, gen, args)}
        out["psum"].update(kernel_report(_build, "psum_mod"))
        print(json.dumps(out))
        return 0
    if kernels == ["answer"]:
        out = {"card": card, "root": os.path.abspath(args.root),
               "answer": bench_answer(torch, dev, gen, args)}
        out["answer"].update(kernel_report(_build, "dp_matmul_u32"))
        out["answer"]["a_2"].update(kernel_report(_build, "dp_dot_i8"))
        print(json.dumps(out))
        return 0
    if kernels == ["dot"]:
        out = {"card": card, "root": os.path.abspath(args.root),
               "dot": bench_dot(torch, dev, gen, args)}
        out["dot"].update(kernel_report(_build, "dp_dot_i8"))
        print(json.dumps(out))
        return 0
    if set(kernels) <= {"ntt", "fold", "pack"}:
        out = {"card": card, "root": os.path.abspath(args.root)}
        for k in kernels:
            stem = {"ntt": "ntt", "fold": "fold_round", "pack": "pack"}[k]
            bench = {"ntt": bench_ntt, "fold": bench_fold,
                     "pack": bench_pack}[k]
            out[k] = bench(torch, params, dev, gen, args)
            out[k].update(kernel_report(_build, stem))
        occ = _build.lib().get("sdk_fold_round_occupancy")
        if "fold" in kernels and occ is not None:
            out["fold"]["blocks_per_sm"] = occ()
        occ = _build.lib().get("sdk_pack_occupancy")
        if "pack" in kernels and occ is not None:
            pairs = sj.pack_tiling(params, 1, sj._sm_count(dev)).pairs
            out["pack"].update(pairs=pairs, blocks_per_sm=occ(
                params.n, params.version, pairs))
        print(json.dumps(out))
        return 0
    if args.kernel == "compact":
        out = {"card": card, "root": os.path.abspath(args.root)}
        for state, cap in (("S1", 8), ("S2", 128)):
            out[state] = bench_compact(torch, sj, params, dev, gen, cap, args)
        if hasattr(_build, "ptxas_usage"):
            out["ptxas"] = _build.ptxas_usage("scan_compact")
        print(json.dumps(out))
        return 0
    db = torch.randint(0, 128, sj.db_shape(params), dtype=torch.int8,
                       device=dev, generator=gen)
    crt, z, L, jw, inst, trials, npr, _ = db.shape
    M = inst * trials * npr
    index_bytes = db.numel()
    out = {"card": card, "root": os.path.abspath(args.root),
           "index_bytes": index_bytes}
    for R in map(int, args.columns.split(",")):
        q_arr = torch.stack([torch.randint(0, q, (z, 4 * jw, R),
                                           dtype=torch.int32, device=dev,
                                           generator=gen)
                             for q in params.moduli])
        zs = 16
        got = sj.firstdim_multiply(params, db[:, :zs].contiguous(),
                                   q_arr[:, :zs].contiguous())
        want = sj.firstdim_multiply_plain(params, db[:, :zs].contiguous(),
                                          q_arr[:, :zs].contiguous())
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"R={R}: kernel != plain (max abs err {err})")
        ms = cuda_ms(lambda: sj.firstdim_multiply(params, db, q_arr),
                     args.iters)
        moved = index_bytes + q_arr.numel() * 4 + crt * z * M * R * 4
        bnd = max(moved / HBM_BYTES_PER_S,
                  2 * index_bytes * 4 * R / INT8_OPS_PER_S) * 1e3
        row = {"ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
               "GBps": index_bytes / ms / 1e6}
        for cols in (8, 32):
            row[f"int_mm_ms_{cols}"] = int_mm_ms(torch, db, cols, args.iters)
        if hasattr(sj, "scan_tiling"):
            tl = sj.scan_tiling(R, M, z, jw)
            row["tiling"] = {"form": type(tl).__name__, **tl._asdict()}
        if args.sweep and hasattr(sj, "resident_scan_tiling") and R > 64:
            row["resident_sweep_ms"] = {
                f"cgb{cgb}_wm{wm}": cuda_ms(lambda: sj._scan_launch(
                    params, db, q_arr, sj.resident_scan_tiling(
                        R, M, z, jw, cgb=cgb, wm=wm)), args.iters)
                for cgb, wm in ((1, 4), (1, 8), (2, 2), (2, 4))}
        if args.sweep and hasattr(sj, "scan_tiling"):
            sweep = {}
            # today's form (the resident one has no ntw: 4 tiles a warp)
            default = getattr(sj.scan_tiling(R, M, z, jw), "ntw", 4)
            for ntw in sorted({default, 2 if R >= 16 else 1}):
                for warps in (4, 8):
                    for mtw in (1, 2, 4, 16):
                        tl = sj.scan_tiling(R, M, z, jw, ntw=ntw, warps=warps,
                                            mtw=mtw)
                        key = f"ntw{ntw}_w{warps}_mtw{tl.mtw}"
                        sweep[key] = cuda_ms(
                            lambda: sj._scan_launch(
                                params, db, q_arr, tl), args.iters)
            row["sweep_ms"] = sweep
        out[f"R{R}"] = row
        del q_arr, got, want
    if hasattr(_build, "ptxas_usage"):
        out["ptxas"] = _build.ptxas_usage("scan")
    out["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
