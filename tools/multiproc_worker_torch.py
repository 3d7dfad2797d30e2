"""Worker for the port's mesh across processes: kernel M's exact mod-q sum
over a torch.distributed group (sdk_tpu_torch.ops.shard.psum_mod_group).

Each of W processes (ranks) holds k = 2 local shards, as each JAX process
of tools/multiproc_worker.py holds two devices; the W * k partials are
gathered by every rank and summed exactly by kernel M on a CUDA tensor (by
its plain version, psum_mod_plain, on a CPU tensor). Every rank checks its
result; rank 0 prints one JSON line a result. The exit code is non-zero
when any check of the rank fails.

Usage:
    python tools/multiproc_worker_torch.py <store_file> <world> <rank>
        [--cpu] [--backend gloo|nccl] [--case toy|bucket]

<store_file> is the rendezvous (a torch FileStore) that the W ranks of
one run share; give each run a fresh path. The worker runs on cuda:0
unless --cpu is given, and without --cpu and a card it exits non-zero.
``run_ranks`` starts the W ranks of one run and waits for them.

--case toy (the default) mirrors tools/multiproc_worker.py: q = 268369921,
ndev = 2 W shards of an (8 ndev, 64) matrix times a (64, 3) vector, seed
7; shard d's partial is its rows' (8, 3) block mod q, and the oracle is
the elementwise mod-q sum of the blocks. Then the same in the Spiral form
(the two moduli of the fast test params, partials (2, 8, 3)) and in the
wrapping form (q = 0: any 32 bits, sums mod 2^32). Rank 0's lines hold
the result words.

--case bucket (the card only) is the 1 GiB bucket's scan
(get_params_from_store(15, 32768): an 8.59 GB dense index, R = 32 query
columns): the index is cut over axis 3 (dim0, in 4-column words) into
W * k shards as ShardedDb.from_dense cuts a db axis of W * k; rank r makes
its k shards on the card from a generator seeded from (SEED, r), limbs in
[0, 128) as the dense index holds them, and the shared columns from SEED.
Each shard's partial is kernel C's (spiral.firstdim_multiply) over its
rows of the columns, as ShardedSpiralScan.scan_fold computes it, then
psum_mod_group sums them. Every rank holds the result against
psum_mod_plain on the gathered parts; rank 0 also remakes every other
rank's shards and holds it against kernel C over the whole index. Rank 0
prints the shapes, C's, the all_gather's and M's times by rank (with
gloo also the all_gather of the same parts from host memory: the
collective without the copies), M's launches by rank, the time of the
library's one-expression sum over the gathered parts (torch.stack(parts)
.sum(0) % q, a yardstick the port never calls), the memory peaks and the
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from sdk_tpu_torch import _build
from sdk_tpu_torch.ops import shard

LOCAL_PARTS = 2          # k: shards a rank, as each JAX process's 2 devices
TOY_Q = 268369921        # Spiral CRT modulus 0, the JAX worker's q
SEED = 20261018
R_BUCKET = 32            # the bucket's query columns (a 16-query batch)
M_REPS = 10              # kernel M calls timed after the counted run
C_REPS = 3               # a rank's k C launches timed after the counted run
GATHER_REPS = 2          # all_gather calls timed after the counted run


def toy_forms(ndev: int) -> dict:
    """form -> (q, blocks): blocks[d] is shard d's uint32 partial. The
    first form draws exactly what tools/multiproc_worker.py draws."""
    from sdk_tpu_torch.params import get_fast_expansion_testing_params

    rows, cols, nq = 8 * ndev, 64, 3
    rng = np.random.default_rng(7)

    def blocks(q: int) -> np.ndarray:
        top = q or 1 << 32
        mat = rng.integers(0, top, (rows, cols), dtype=np.uint64)
        vec = rng.integers(0, top, (cols, nq), dtype=np.uint64)
        prod = mat @ vec                 # wraps mod 2^64: exact mod 2^32
        prod = prod % np.uint64(q) if q else prod & np.uint64(0xFFFFFFFF)
        return prod.astype(np.uint32).reshape(ndev, rows // ndev, nq)

    one = blocks(TOY_Q)
    moduli = get_fast_expansion_testing_params().moduli
    spiral = np.stack([blocks(q) for q in moduli], axis=1)
    return {"one": (TOY_Q, one), "spiral": (list(moduli), spiral),
            "wrap": (0, blocks(0))}


def oracle(q, blocks: np.ndarray) -> np.ndarray:
    """The elementwise sum of the shards' blocks, mod q per channel (axis 1
    of the blocks for two moduli) or mod 2^32 for q = 0."""
    acc = blocks.astype(np.uint64).sum(axis=0)
    if isinstance(q, list):
        mods = np.array(q, dtype=np.uint64).reshape((-1,) + (1,) * (acc.ndim - 1))
        return (acc % mods).astype(np.uint32)
    return (acc % np.uint64(q) if q else acc & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32)


def run_toy(world: int, rank: int, dev: torch.device, group) -> bool:
    ndev = world * LOCAL_PARTS
    ok = True
    for form, (q, blocks) in toy_forms(ndev).items():
        parts = [torch.from_numpy(blocks[rank * LOCAL_PARTS + i].view(np.int32))
                 .to(dev) for i in range(LOCAL_PARTS)]
        _build.reset_launches()
        got = shard.psum_mod_group(parts, q, group)
        launches = _build.LAUNCHES["psum_mod"]
        words = got.cpu().numpy().view(np.uint32)
        good = bool(np.array_equal(words, oracle(q, blocks)))
        if not good:
            print(f"rank {rank}: {form} differs from the numpy oracle",
                  file=sys.stderr, flush=True)
        ok = ok and good
        if rank == 0:
            print(json.dumps({"case": "toy", "form": form, "q": q,
                              "world": world, "k": LOCAL_PARTS, "ndev": ndev,
                              "device": str(dev), "shape": list(words.shape),
                              "ok": good, "m_launches": launches,
                              "words": words.ravel().tolist()}), flush=True)
    return ok


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def run_bucket(world: int, rank: int, dev: torch.device, group,
               backend: str) -> bool:
    from sdk_tpu_torch.ops import spiral as sj
    from sdk_tpu_torch.params_store import get_params_from_store

    params = get_params_from_store(15, 32768)
    shape = sj.db_shape(params)
    k, db = LOCAL_PARTS, world * LOCAL_PARTS
    if shape[3] % db:
        raise SystemExit(f"{db} shards do not divide dim0 / 4 = {shape[3]}")
    jw = shape[3] // db
    shard_shape = shape[:3] + (jw,) + shape[4:]

    def rank_shards(r: int) -> list:
        gen = torch.Generator(device=dev).manual_seed(SEED << 16 | r)
        return [torch.randint(0, 128, shard_shape, dtype=torch.int8,
                              device=dev, generator=gen) for _ in range(k)]

    gen = torch.Generator(device=dev).manual_seed(SEED)
    z, dim0 = params.poly_len, 4 * shape[3]
    q_all = torch.stack([torch.randint(0, q, (z, dim0, R_BUCKET),
                                       dtype=torch.int32, device=dev,
                                       generator=gen)
                         for q in params.moduli])
    shards = rank_shards(rank)
    d0 = 4 * jw
    cols = [q_all[:, :, j * d0:(j + 1) * d0].contiguous()
            for j in range(rank * k, rank * k + k)]
    torch.cuda.synchronize(dev)
    torch.distributed.barrier(group)

    # the counted run: k C launches, then psum_mod_group (one M)
    _build.reset_launches()
    c0, c1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    c0.record()
    parts = [sj.firstdim_multiply(params, s, c) for s, c in zip(shards, cols)]
    c1.record()
    t = time.perf_counter()
    got = shard.psum_mod_group(parts, params.moduli, group)
    torch.cuda.synchronize(dev)
    group_ms = (time.perf_counter() - t) * 1e3
    launches = dict(_build.LAUNCHES)
    stats = {"c_first_ms": c0.elapsed_time(c1), "group_ms": group_ms,
             "c_launches": launches["scan"],
             "m_launches": launches["psum_mod"]}
    c0.record()
    for _ in range(C_REPS):
        for s, c in zip(shards, cols):
            sj.firstdim_multiply(params, s, c)
    c1.record()
    torch.cuda.synchronize(dev)
    stats["c_ms"] = c0.elapsed_time(c1) / C_REPS

    gather_ms = []
    for _ in range(GATHER_REPS):
        torch.distributed.barrier(group)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        gathered = shard.all_gather_parts(parts, group)
        torch.cuda.synchronize(dev)
        gather_ms.append((time.perf_counter() - t) * 1e3)
    if backend == "gloo":
        # the collective alone: the same parts gathered from host memory
        host_parts = [p.cpu() for p in parts]
        torch.distributed.barrier(group)
        t = time.perf_counter()
        shard.all_gather_parts(host_parts, group)
        stats["host_all_gather_ms"] = (time.perf_counter() - t) * 1e3
        del host_parts
    m0, m1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    m0.record()
    for _ in range(M_REPS):
        shard.psum_mod(gathered, params.moduli)
    m1.record()
    plain = shard.psum_mod_plain(gathered, params.moduli)
    m2 = torch.cuda.Event(enable_timing=True)
    m2.record()
    # the library yardstick (never called by the port): one PyTorch
    # expression of the same sum over the gathered parts
    qcol = torch.tensor(params.moduli, dtype=torch.int64, device=dev
                        ).reshape((2,) + (1,) * (gathered[0].ndim - 1))
    torch.stack(gathered).sum(0) % qcol
    m3 = torch.cuda.Event(enable_timing=True)
    m3.record()
    for _ in range(M_REPS):
        torch.stack(gathered).sum(0) % qcol
    m4 = torch.cuda.Event(enable_timing=True)
    m4.record()
    torch.cuda.synchronize(dev)
    stats.update(all_gather_ms=gather_ms, m_ms=m0.elapsed_time(m1) / M_REPS,
                 plain_ms=m1.elapsed_time(m2),
                 library_ms=m3.elapsed_time(m4) / M_REPS,
                 m_vec4=shard.psum_mod_vec4(gathered, params.moduli),
                 plain_err=max_err(got, plain),
                 digest=hashlib.sha256(got.cpu().numpy().tobytes())
                 .hexdigest()[:16])
    del gathered, plain

    whole_err = None
    if rank == 0:
        whole = torch.empty(shape, dtype=torch.int8, device=dev)
        for r in range(world):
            for i, s in enumerate(shards if r == rank else rank_shards(r)):
                j = r * k + i
                whole[:, :, :, j * jw:(j + 1) * jw] = s
        whole_err = max_err(got, sj.firstdim_multiply(params, whole, q_all))
        del whole
    stats["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)

    every = [None] * world
    torch.distributed.all_gather_object(every, stats, group)
    ok = (stats["plain_err"] == 0 and stats["m_launches"] == 1
          and stats["c_launches"] == k)
    if rank == 0:
        same = len({s["digest"] for s in every}) == 1
        ok = ok and whole_err == 0 and same
        part = parts[0]
        print(json.dumps({
            "case": "bucket", "backend": backend, "world": world, "k": k,
            "device": str(dev), "two_processes_on_one_card": world > 1,
            "index_bytes": int(np.prod(shape)),
            "shard_shape": list(shard_shape),
            "shard_bytes": int(np.prod(shard_shape)),
            "partial_shape": list(part.shape),
            "partial_bytes": part.numel() * part.element_size(),
            "gathered_parts": world * k,
            "c_ms": [s["c_ms"] for s in every],
            "c_first_ms": [s["c_first_ms"] for s in every],
            "c_launches": [s["c_launches"] for s in every],
            "group_ms": [s["group_ms"] for s in every],
            "all_gather_ms": [s["all_gather_ms"] for s in every],
            "host_all_gather_ms": [s.get("host_all_gather_ms")
                                   for s in every],
            "m_ms": [s["m_ms"] for s in every],
            "m_launches": [s["m_launches"] for s in every],
            "plain_ms": [s["plain_ms"] for s in every],
            "library_ms": [s["library_ms"] for s in every],
            "m_vec4": [s["m_vec4"] for s in every],
            "max_abs_err_plain": [s["plain_err"] for s in every],
            "max_abs_err_whole_index": whole_err,
            "same_result_on_every_rank": same,
            "peak_allocated_bytes": [s["peak_allocated_bytes"] for s in every],
            "reckoned_peak_bytes": reckon(shape, shard_shape, part, world,
                                          q_all),
            "card": card_line(), "ok": ok}), flush=True)
    return ok


def reckon(shape, shard_shape, part, world: int, q_all) -> dict:
    """Device bytes a rank holds at its peak, worked out from the shapes
    (not measured). Each rank: its k shards, the columns and its slices of
    them, its k partials, the result, the W * k gathered parts and about 8
    partials' bytes of the plain check's int64 sums. Rank 0's check: the
    shards, columns, partials and result, the whole index, the k shards of
    one other rank remade beside it, C's output over the whole index and
    about 6 partials' bytes of int64 differences."""
    k = LOCAL_PARTS
    sb, ib = int(np.prod(shard_shape)), int(np.prod(shape))
    pb = part.numel() * part.element_size()
    qb = q_all.numel() * q_all.element_size()
    held = k * sb + qb + qb // world + (k + 1) * pb
    return {"each_rank": held + (world * k + 8) * pb,
            "rank0_check": held + ib + (k * sb if world > 1 else 0) + 7 * pb}


def run_ranks(world: int, run_dir: str, args=(), timeout: float = 120.0) -> list:
    """Start the ranks 0 .. world - 1 of one run of this worker, each a
    process of its own, over the store ``run_dir``/store (a fresh directory
    a run); wait at most ``timeout`` seconds for all of them, and kill
    every one still running as soon as one fails or the time is up (a rank
    left alone waits in its collective). Returns (returncode, stdout,
    stderr) a rank; a killed rank's code is negative."""
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.join(run_dir, "store")
    procs, files = [], []
    for r in range(world):
        out = open(os.path.join(run_dir, f"rank{r}.out"), "w+")
        err = open(os.path.join(run_dir, f"rank{r}.err"), "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), store, str(world),
             str(r), *args], stdout=out, stderr=err, cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("store_file")
    ap.add_argument("world", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", choices=shard.GROUP_BACKENDS, default="gloo")
    ap.add_argument("--case", choices=("toy", "bucket"), default="toy")
    a = ap.parse_args(argv)
    if a.world < 1 or not 0 <= a.rank < a.world:
        ap.error(f"rank {a.rank} of a world of {a.world}")
    if a.world * LOCAL_PARTS > shard.MAX_PARTS:
        ap.error(f"a world of {a.world} x {LOCAL_PARTS} parts is more than "
                 f"kernel M's {shard.MAX_PARTS}")
    if a.cpu and (a.case == "bucket" or a.backend == "nccl"):
        ap.error("--case bucket and --backend nccl run on the card only")
    if not a.cpu and not torch.cuda.is_available():
        print("multiproc_worker_torch: no CUDA device "
              "(torch.cuda.is_available() is False); --cpu runs on the CPU",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device("cpu") if a.cpu else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = shard.init_group(a.backend, "file://" + os.path.abspath(
        a.store_file), a.rank, a.world)
    try:
        if a.case == "toy":
            ok = run_toy(a.world, a.rank, dev, group)
        else:
            ok = run_bucket(a.world, a.rank, dev, group, a.backend)
    finally:
        torch.distributed.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
