"""The port's mesh across processes (ops/shard.psum_mod_group) against
the numpy oracle and JAX's psum_mod, word for word (tolerance 0).

One spawn a world: W = 2 and W = 3 gloo ranks of
tools/multiproc_worker_torch.py --cpu --case toy (k = 2 shards a rank, so
ndev = 4 and 6), over a FileStore under a fresh temporary directory. Each
rank gathers every rank's int32 partials and sums them with the plain
version of kernel M. Rank 0's lines hold the result of each q form (one
modulus, the two Spiral moduli, q = 0); the tests hold them against the
elementwise sum of the seed-7 row blocks of tools/multiproc_worker.py and
against sdk_tpu.ops.shard.psum_mod under shard_map over ndev of the 8
virtual CPU devices (for q = 0 the JAX package's wrapping sum,
jax.lax.psum of uint32, as its checklist sums its shards). The refusals
run in this process with no process group. Kernel M itself runs only on
the card (chip_smoke.py's multiproc phase).
"""

import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from sdk_tpu.ops import shard as shard_j
from sdk_tpu_torch.ops import shard
from sdk_tpu_torch.params import get_fast_expansion_testing_params

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import multiproc_worker_torch as worker  # noqa: E402

torch.set_num_threads(1)
WORLDS = (2, 3)
FORMS = ("one", "spiral", "wrap")
TIMEOUT_S = 120.0


def seed7_blocks(ndev: int) -> dict:
    """The row blocks of tools/multiproc_worker.py (seed 7: mat, vec, mod
    q = 268369921), then a two-moduli and a wrapping draw from the same
    generator: form -> (q, uint32 blocks (ndev, [2,] 8, 3))."""
    rows, cols, nq = 8 * ndev, 64, 3
    rng = np.random.default_rng(7)

    def draw(q):
        top = q or 1 << 32
        mat = rng.integers(0, top, (rows, cols), dtype=np.uint64)
        vec = rng.integers(0, top, (cols, nq), dtype=np.uint64)
        full = mat @ vec
        full = full % np.uint64(q) if q else full & np.uint64(0xFFFFFFFF)
        return full.astype(np.uint32).reshape(ndev, rows // ndev, nq)

    one = draw(268369921)
    moduli = list(get_fast_expansion_testing_params().moduli)
    spiral = np.stack([draw(q) for q in moduli], axis=1)
    return {"one": (268369921, one), "spiral": (moduli, spiral),
            "wrap": (0, draw(0))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (the ranks' (returncode, stdout, stderr), rank 0's lines by
    form); both worlds spawned at once."""
    base = tmp_path_factory.mktemp("multiproc")

    def spawn(world):
        return worker.run_ranks(world, str(base / f"w{world}"),
                                ["--cpu", "--case", "toy"], TIMEOUT_S)

    with ThreadPoolExecutor(len(WORLDS)) as ex:
        results = dict(zip(WORLDS, ex.map(spawn, WORLDS)))
    out = {}
    for world, ranks in results.items():
        lines = [json.loads(x) for x in ranks[0][1].splitlines()
                 if x.startswith("{")]
        out[world] = (ranks, {d["form"]: d for d in lines})
    return out


def result_words(runs, world, form) -> np.ndarray:
    line = runs[world][1][form]
    return np.array(line["words"], dtype=np.uint32).reshape(line["shape"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_exits_zero(runs, world):
    ranks, lines = runs[world]
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} of {world}: rc {rc}\n{err[-3000:]}"
    assert sorted(lines) == sorted(FORMS)
    for d in lines.values():
        assert d["ok"] and d["world"] == world and d["ndev"] == 2 * world
        assert d["device"] == "cpu" and d["m_launches"] == 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("world", WORLDS)
def test_matches_numpy_oracle(runs, world, form):
    """The elementwise sum of the ndev row blocks, mod q per channel (mod
    2^32 for q = 0), as tools/multiproc_worker.py's oracle sums them."""
    q, blocks = seed7_blocks(2 * world)[form]
    acc = blocks.astype(np.uint64).sum(axis=0)
    if form == "spiral":
        want = np.stack([acc[c] % np.uint64(m) for c, m in enumerate(q)])
    else:
        want = acc % np.uint64(q) if q else acc & np.uint64(0xFFFFFFFF)
    np.testing.assert_array_equal(result_words(runs, world, form),
                                  want.astype(np.uint32))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("world", WORLDS)
def test_matches_jax_psum_mod(runs, world, form):
    """JAX's psum_mod under shard_map over the ndev = 2 W devices, one block
    a device: per channel with its modulus in the Spiral form; for q = 0
    jax.lax.psum of the uint32 blocks."""
    ndev = 2 * world
    q, blocks = seed7_blocks(ndev)[form]
    mesh = shard_j.make_mesh(ndev, dp=1)

    def summed(x, modulus):
        @functools.partial(shard_j.shard_map, mesh=mesh,
                           in_specs=P("db", None, None),
                           out_specs=P("db", None, None), check_rep=False)
        def f(s):
            if modulus == 0:
                return jax.lax.psum(s, "db")
            return shard_j.psum_mod(s, modulus, "db")

        return np.asarray(jax.jit(f)(jnp.asarray(x)))[0]

    if form == "spiral":
        want = np.stack([summed(blocks[:, c], m) for c, m in enumerate(q)])
    else:
        want = summed(blocks, q)
    np.testing.assert_array_equal(result_words(runs, world, form), want)


def _no_collective(*args, **kwargs):
    raise AssertionError("a refused call reached a collective")


@pytest.mark.parametrize("case", ["too_many_parts", "mixed_shapes",
                                  "mixed_dtypes", "nccl_with_cpu_parts"])
def test_refusals_before_any_collective(monkeypatch, case):
    """With no process group in this process: W * k > MAX_PARTS, parts of
    mixed shapes or dtypes within the rank, and an NCCL group with CPU parts
    raise ValueError, and no collective is called."""
    assert not dist.is_initialized()
    world = {"too_many_parts": shard.MAX_PARTS // 2 + 1}.get(case, 2)
    backend = "nccl" if case == "nccl_with_cpu_parts" else "gloo"
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    for name in ("all_gather", "all_gather_into_tensor", "all_reduce",
                 "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, _no_collective)
    a = torch.zeros((8, 3), dtype=torch.int32)
    b = {"mixed_shapes": torch.zeros((4, 3), dtype=torch.int32),
         "mixed_dtypes": torch.zeros((8, 3), dtype=torch.int64)}.get(case, a)
    with pytest.raises(ValueError):
        shard.psum_mod_group([a, b], 268369921)
    with pytest.raises(ValueError):
        shard.all_gather_parts([a, b])


@pytest.mark.parametrize("world,rank", [("2", "5"), ("0", "0")],
                         ids=["bad_rank", "bad_world"])
def test_worker_refuses_bad_rank_or_world(tmp_path, world, rank):
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "multiproc_worker_torch.py"),
         str(tmp_path / "store"), world, rank, "--cpu"],
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode != 0
    assert not [x for x in res.stdout.splitlines() if x.startswith("{")]


def test_ranks_are_killed_at_the_timeout(tmp_path):
    """run_ranks kills every rank still running when its time is up (here
    before the ranks have imported torch) and reports their non-zero
    codes."""
    ranks = worker.run_ranks(2, str(tmp_path / "run"), ["--cpu"], timeout=0.5)
    assert [rc < 0 for rc, _, _ in ranks] == [True, True]
    assert not any(out for _, out, _ in ranks)
