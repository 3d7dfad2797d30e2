#!/usr/bin/env python3
"""Drive the sdk_tpu_torch Spiral private-read path once on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, with no result line):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from sdk_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (1 GiB bucket), exactly (integer results,
   tolerance 0), timed with CUDA events.
4. small configs: whole responses of the port on the card byte-identical
   to the host oracle (server_host.process_query), and decoding.
5. full size: the 1 GiB bucket (2^15 items x 32 KiB, an 8.59 GB index)
   filled with seeded random rows through the device ingest, three keys
   written, each read through private_read and decoded, then one 16-query
   batch from 4 client sessions, every response decoded. The scan kernel
   is also held against its plain version on a z-slice of this index.
6. report: launches of every kernel during step 5's reads (each must be
   > 0), index bytes, peak device memory, read and batch wall times, and
   the kernel table as one JSON line; then, as the last line, the device.
"""

from __future__ import annotations

import base64
import bz2
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
V1_SMALL = ('{"n": 2, "nu_1": 5, "nu_2": 2, "p": 256, "q2_bits": 22,'
            ' "t_gsw": 7, "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5,'
            ' "instances": 2, "db_item_size": 16384, "version": 1}')
KEYS = ("alpha", "bravo", "charlie")


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


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max())


def residues(params, gen: np.random.Generator, lead: tuple, dev):
    x = np.stack([gen.integers(0, q, lead + (params.poly_len,))
                  for q in params.moduli], axis=-2)
    return torch.from_numpy(x.astype(np.int32)).to(dev)


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

    def timed(self, name, source, replaces, shape, ms, plain_ms, **extra):
        """The kernel's row: where it comes from and its timed shape."""
        self.rows[name].update(route="cuda", source=source, replaces=replaces,
                               launches=0, ms=ms, plain_ms=plain_ms,
                               shape=shape, **extra)


def phase_kernels(params, dev, table: KernelTable) -> None:
    from sdk_tpu_torch.ops import ntt, spiral as sj
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    gen = np.random.default_rng(SEED)
    # A / A': 4096 polys x 2 channels, reduced and digit-range inputs
    x = residues(params, gen, (4096,), dev)
    digits = torch.from_numpy(gen.integers(0, 1 << 19, (4096, 2, 2048))
                              .astype(np.int32)).to(dev)
    src = "sdk_tpu_torch/csrc/ntt.cu"
    for name, fn, plain, replaces, inputs in (
            ("ntt_forward", ntt.ntt_forward, ntt.ntt_forward_plain,
             "sdk_tpu/ops/ntt_jax.py:199", (x, digits)),
            ("ntt_inverse", ntt.ntt_inverse, ntt.ntt_inverse_plain,
             "sdk_tpu/ops/ntt_jax.py:215", (x,))):
        for i, inp in enumerate(inputs):
            table.check(name, "digits" if i else "residues",
                        max_abs_err(fn(params, inp), plain(params, inp)))
        table.timed(name, src, replaces, "(4096, 2, 2048) int32 residues",
                    cuda_ms(lambda: fn(params, x), 20),
                    cuda_ms(lambda: plain(params, x), 3))

    # B: the fold round [V_neg|V_fold] @ digits (k = 4*t_gsw, batch
    # IT*num_per/2), the keyed expansion product, the keyed v1 pack product
    ell = 2 * params.t_gsw
    it_half = params.instances * params.n * params.n * (1 << params.db_dim_2) // 2
    t_exp = params.t_exp_left

    def keyed(m):
        return (m, u32_bits(shoup_companion_arr(
            params, m.cpu().numpy().astype(np.uint64)), dev))

    cases = (
        ("fold", residues(params, gen, (2, 2 * ell), dev),
         residues(params, gen, (it_half, 2 * ell, 1), dev)),
        ("expansion keyed", keyed(residues(params, gen, (2, t_exp), dev)),
         residues(params, gen, (512, t_exp, 1), dev)),
        ("pack v1 keyed",
         keyed(residues(params, gen, (params.n + 1, params.t_conv), dev)),
         residues(params, gen, (params.t_conv, 1), dev)))
    for label, a, b in cases:
        a_plain = a[0] if isinstance(a, tuple) else a
        table.check("matmul_mod", label, max_abs_err(
            sj.matmul_mod(params, a, b),
            sj.matmul_mod_plain(params, a_plain, b)))
    _, a, b = cases[0]
    table.timed("matmul_mod", "sdk_tpu_torch/csrc/matmul_mod.cu",
                "sdk_tpu/ops/spiral_jax.py:108",
                f"fold round: {tuple(a.shape)} x {tuple(b.shape)} int32",
                cuda_ms(lambda: sj.matmul_mod(params, a, b), 20),
                cuda_ms(lambda: sj.matmul_mod_plain(params, a, b), 3))

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
                cuda_ms(lambda: plan.encode_plain(packed), 3))


def phase_small_configs(dev) -> None:
    from sdk_tpu import poly, server_host
    from sdk_tpu.arith import log2_ceil
    from sdk_tpu.client import Client
    from sdk_tpu.params import get_fast_expansion_testing_params, params_from_json
    from sdk_tpu.rng import ChaCha20Rng
    from sdk_tpu_torch.ops.server import SpiralServerTorch

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
        item, db = server_host.generate_random_db_and_get_item(params, target)
        srv = SpiralServerTorch(params, dev)
        srv.set_db_host_tensor(db)
        got = srv.process_query(pp, query)
        if got != server_host.process_query(params, pp, query, db):
            raise AssertionError(f"{label}: response differs from the host "
                                 f"oracle")
        want = poly.raw_to_bytes(params, item, log2_ceil(params.pt_modulus),
                                 params.modp_words_per_chunk())
        if client.decode_response(got) != want:
            raise AssertionError(f"{label}: response does not decode")
        log(f"[small] {label}: {len(got)} bytes, byte-identical to "
            f"server_host.process_query, decodes")


def check_value(client, response: bytes, key: str, value: bytes) -> None:
    from sdk_tpu.kv.key_value import extract_result

    payload = bz2.BZ2Decompressor().decompress(client.decode_response(response))
    if extract_result(key, payload) != value:
        raise AssertionError(f"read of {key!r} decoded to the wrong value")


def phase_full(dev, table: KernelTable) -> dict:
    from sdk_tpu.client import Client
    from sdk_tpu.kv.key_value import row_from_key
    from sdk_tpu.params_store import get_params_from_store
    from sdk_tpu.rng import ChaCha20Rng
    from sdk_tpu_torch import _build
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.ops.server import index_hbm_bytes
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    params = get_params_from_store(15, 32768)
    out = {"params": {"nu_1": params.db_dim_1, "nu_2": params.db_dim_2,
                      "instances": params.instances,
                      "version": params.version},
           "index_bytes": index_hbm_bytes(params)}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = SpiralKvServerTorch(params, device=dev)
    n_items = params.num_items()
    row_bytes = params.instances * params.n * params.n * params.bytes_per_chunk()
    gen = np.random.default_rng(SEED + 1)
    step = min(4096, n_items)
    for s in range(0, n_items, step):
        rows = gen.integers(0, 256, (step, row_bytes), dtype=np.uint8)
        for i in range(step):
            srv.update_item_raw(s + i, rows[i].tobytes())
        srv.flush()
    torch.cuda.synchronize()
    out["fill_s"] = time.perf_counter() - t0
    log(f"[full] filled {n_items} items x {row_bytes} B through the device "
        f"ingest in {out['fill_s']:.1f} s")

    value_len = min(16384, row_bytes // 4)   # 16 KiB at the 1 GiB bucket
    values = {k: bytes(gen.integers(0, 256, value_len, dtype=np.uint8))
              for k in KEYS}
    srv.write_kv(json.dumps({k: base64.b64encode(v).decode()
                             for k, v in values.items()}).encode())
    srv.flush()

    # scan kernel vs plain on a z-slice of the filled index
    zs = 64
    db = srv.engine.db
    db_slice = db[:, :zs].contiguous()
    dim0 = 1 << params.db_dim_1
    extra = {}
    for R in (2, 32):
        q_full = torch.stack([torch.from_numpy(
            gen.integers(0, q, (params.poly_len, dim0, R)).astype(np.int32))
            for q in params.moduli]).to(dev)
        q_slice = q_full[:, :zs].contiguous()
        got = sj.firstdim_multiply(params, db_slice, q_slice)
        table.check("scan", f"R={R} z-slice", max_abs_err(
            got, sj.firstdim_multiply_plain(params, db_slice, q_slice)))
        table.check("scan", f"R={R} full index", max_abs_err(
            sj.firstdim_multiply(params, db, q_full)[:, :zs], got))
        extra[f"ms_R{R}"] = cuda_ms(
            lambda: sj.firstdim_multiply(params, db_slice, q_slice), 10)
        extra[f"plain_ms_R{R}"] = cuda_ms(
            lambda: sj.firstdim_multiply_plain(params, db_slice, q_slice), 2)
        full_ms = cuda_ms(lambda: sj.firstdim_multiply(params, db, q_full), 5)
        extra[f"full_index_ms_R{R}"] = full_ms
        extra[f"full_index_GBps_R{R}"] = out["index_bytes"] / full_ms / 1e6
    table.timed("scan", "sdk_tpu_torch/csrc/scan.cu",
                "sdk_tpu/ops/spiral_jax.py:430",
                f"z-slice {zs} of {params.poly_len} of the filled index, "
                f"R=2 (ms, plain_ms); R=32 and the full index in *_R*",
                extra["ms_R2"], extra["plain_ms_R2"], **extra)
    del db_slice, got, q_full, q_slice

    # sessions: one client for single reads, four for the batch
    clients, uids = [], []
    for ci in range(5):
        c = Client(params)
        pp = c.generate_keys_from_seed(
            bytes([0x50 + ci]) * 32, noise_rng=ChaCha20Rng(bytes([0x60 + ci]) * 32),
            pp_seed=bytes([0x70 + ci]) * 32)
        uid = srv.setup(json.dumps(base64.b64encode(
            pp.serialize(params)).decode()).encode())
        clients.append(c)
        uids.append(uid)

    def blob(ci: int, key: str, salt: int) -> bytes:
        q = clients[ci].generate_query(
            row_from_key(n_items, key),
            noise_rng=ChaCha20Rng(bytes([0x80 + salt]) * 32),
            query_seed=bytes([0xA0 + salt]) * 32)
        return uids[ci].encode() + q.serialize(params)

    single = [blob(0, k, i) for i, k in enumerate(KEYS)]
    batch_keys = [KEYS[i % len(KEYS)] for i in range(16)]
    batch = [blob(1 + i // 4, k, 8 + i) for i, k in enumerate(batch_keys)]

    _build.reset_launches()
    lat = []
    for rnd in range(2):
        for key, b in zip(KEYS, single):
            t = time.perf_counter()
            body = srv.private_read(json.dumps(
                [base64.b64encode(b).decode()]).encode())
            lat.append(time.perf_counter() - t)
            resp = base64.b64decode(json.loads(body)[0])
            check_value(clients[0], resp, key, values[key])
    log(f"[full] {len(lat)} single reads through private_read decoded to "
        f"the written values")
    batch_s = []
    for _ in range(3):
        t = time.perf_counter()
        resps = srv.dispatch_read_blobs(batch)()
        batch_s.append(time.perf_counter() - t)
        for i, (key, resp) in enumerate(zip(batch_keys, resps)):
            check_value(clients[1 + i // 4], resp, key, values[key])
    log("[full] 3 x 16-query batches (4 sessions x 4 queries) decoded to "
        "the written values")
    launches = dict(_build.LAUNCHES)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")
        table.rows[name]["launches"] = n
    out.update(
        launches=launches,
        single_read_ms_median=float(np.median(lat)) * 1e3,
        single_read_ms_all=[x * 1e3 for x in lat],
        batch16_ms_median=float(np.median(batch_s)) * 1e3,
        batch16_ms_all=[x * 1e3 for x in batch_s],
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        recall_at_1=1.0)
    out["stages_ms"] = stage_breakdown(srv, clients[0], single[0])
    return out


def stage_breakdown(srv, client, blob: bytes) -> dict:
    """Median wall ms of each stage of one read, synchronised per stage
    (for the breakdown only; the launches are not counted)."""
    eng = srv.engine
    pp_dev, query = srv._parse_request(blob)
    from sdk_tpu_torch.ops import spiral as sj

    times: dict[str, list] = {"expand": [], "scan": [], "fold": [],
                              "pack_encode": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        q_arr, v_folding = eng.expand_query(pp_dev, query)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        inter = sj.firstdim_multiply(eng.params, eng.db, q_arr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        folded = eng._fold(inter, v_folding)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        eng._pack_encode(folded, pp_dev["v_packing"])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(times, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            times[k].append(v * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


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
        f"{torch.cuda.device_count()} device(s)")

    from sdk_tpu.params_store import get_params_from_store
    from sdk_tpu_torch import _build

    t = time.perf_counter()
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t:.1f} s")

    table = KernelTable()
    phase_kernels(get_params_from_store(15, 32768), dev, table)
    log("[kernels] A, A', B, D equal their plain versions at the main "
        "path's shapes")
    phase_small_configs(dev)
    full = phase_full(dev, table)
    log("[full] scan equals its plain version on the filled index "
        "(R=2, R=32)")

    log("[report] " + json.dumps({"card": card, **full}))
    log(card)
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
