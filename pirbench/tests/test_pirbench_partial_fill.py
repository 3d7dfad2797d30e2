"""A partly filled bucket: the configuration names how many rows are
written and where (``fill.rows``, ``fill.at``) and the layout they must
leave (``fill.expect``); a mix with ``rows: "written"`` reads only those
rows. Without the new keys, the fill and the plan are the parent's, digest
for digest. The runs are on the port's plain CPU path (--cpu-tiny), with a
configuration, mixes and cells added in a copy of the benchmark."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil
from dataclasses import replace

import pytest
import torch

from pirbench.harness import service
from pirbench.harness.cells import load_cell
from pirbench.harness.faults import FAULTS
from pirbench.harness.traffic import plan
from pirbench.run import TINY_PARAMS, run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BASE = load_cell(ROOT, "spiral-1gib-window25.batched")
# 4,096 of the 1 GiB bucket's 32,768 rows at their keys' hashes: 12.5%, the
# largest fill that stays compact; 32 of --cpu-tiny's 256 rows
EIGHTH = dict(BASE.config, name="spiral-1gib-eighth-test",
              fill={"rows": 4096, "row_bytes": 32768, "at": "key_hash",
                    "flush_every": 4096,
                    "expect": {"index_layout": "compact",
                               "sparse_expansion": False}})
# a run long enough here for requests of ~8 s on the plain CPU path to
# complete inside the window
SECONDS = 20
# the parent's plan of batched8 over the 32,768 rows, and its fill at the
# --cpu-tiny params: every write (row, SHA-256 of its bytes) and flush
PLAN_DIGESTS = {
    3000000031: "83693308cdf482ee301e85562d0dfd1e742c98553cdadb2820d27762fdb572c3",
    7: "1f8d577f990dfbcc873250f27ac6bc34df0afab46dd908fdb14f944e00eb788c"}
FILL_DIGESTS = {
    64: (4, "58e34dfc4dc51912d1af86772c0a765e587add4b095c24296468dd281555c975"),
    4096: (1, "8be9665f1563fbcf96da8d0d324f46080f8f1dcb838b721c775321752ab6ef4c")}


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


class Recorder:
    """A bucket that records every write and flush of a fill."""

    def __init__(self):
        self.log = hashlib.sha256()
        self.flushes = 0
        self.engine = type("Engine", (), {"db": torch.zeros(4)})()

    def update_item_raw(self, db_idx, data):
        self.log.update(f"w{db_idx}:".encode() + hashlib.sha256(data).digest())

    def flush(self):
        self.log.update(b"flush")
        self.flushes += 1

    def meta(self):
        return {"index_layout": "dense"}


def test_default_fill_and_plan_are_the_parents():
    rows = service.written_rows(BASE.config, BASE.config["params"], 5)
    assert rows == list(range(32768))
    for seed, want in PLAN_DIGESTS.items():
        assert digest(plan(BASE.traffic, seed, range(32768))) == want
    tiny = service.written_rows(BASE.config, TINY_PARAMS, 3000000031)
    assert tiny == list(range(256))
    for flush_every, (flushes, want) in FILL_DIGESTS.items():
        srv = Recorder()
        out = service.fill(srv, TINY_PARAMS, tiny, 3000000031,
                           torch.device("cpu"), flush_every, {3, 200})
        assert (srv.flushes, srv.log.hexdigest()) == (flushes, want)
        assert sorted(out["rows"]) == [3, 200]
        assert out["layouts"] == ["dense"] * flushes


def first_distinct_rows(num_items: int, seed: int, n: int) -> list[int]:
    """The first n distinct rows of the keys "<seed>:0", "<seed>:1", ... by
    the port's own key hash."""
    from sdk_tpu_torch.kv.key_value import row_from_key

    rows, i = [], 0
    while len(rows) < n:
        row = row_from_key(num_items, f"{seed}:{i}")
        if row not in rows:
            rows.append(row)
        i += 1
    return rows


def test_written_rows_at_key_hash():
    rows = service.written_rows(EIGHTH, EIGHTH["params"], 3000000037)
    assert len(set(rows)) == 4096
    assert rows == first_distinct_rows(32768, 3000000037, 4096)
    assert rows == service.written_rows(EIGHTH, EIGHTH["params"], 3000000037)
    assert rows != service.written_rows(EIGHTH, EIGHTH["params"], 3000000038)
    # --cpu-tiny keeps the share: 32 of 256 rows
    assert (service.written_rows(EIGHTH, TINY_PARAMS, 3000000037)
            == first_distinct_rows(256, 3000000037, 32))


@pytest.mark.parametrize("fill,why", [
    ({"rows": 4096, "flush_every": 4096}, "needs fill.at"),
    ({"rows": 4096, "at": "in_order", "flush_every": 4096}, "key_hash"),
    ({"rows": 0, "at": "key_hash", "flush_every": 4096}, "1 to 32768"),
])
def test_a_fill_the_harness_cannot_make_is_refused(fill, why):
    with pytest.raises(ValueError, match=why):
        service.written_rows(dict(EIGHTH, fill=fill), EIGHTH["params"], 1)


@pytest.mark.parametrize("seed", [1, 3000000041, 2**31 + 5])
def test_written_mix_never_draws_an_unwritten_row(seed):
    written = service.written_rows(EIGHTH, EIGHTH["params"], seed)
    mix = replace(BASE.traffic, rows="written", clients=16,
                  pool_per_client=64)
    drawn = [r for proc in plan(mix, seed, written) for c in proc
             for req in c["pool"] for r in req]
    assert set(drawn) <= set(written)
    assert len(set(drawn)) > 1000


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the partial fill's configuration, a
    mix of batched8 over the written rows, a cell of it and one of batched8
    over every row, and a cell whose configuration expects the wrong
    layout."""
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(ROOT, "pirbench"), tmp / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wrong = copy.deepcopy(EIGHTH)
    wrong["name"] = "spiral-1gib-eighth-wrong"
    wrong["fill"]["expect"] = {"index_layout": "dense",
                               "sparse_expansion": False}
    with open(os.path.join(ROOT, "pirbench", "traffic", "batched8.json")) as f:
        batched8 = json.load(f)
    for cfg in (EIGHTH, wrong):
        (tmp / "pirbench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({
            "name": cfg["name"], "source": "a test",
            "file": f"pirbench/configs/{cfg['name']}.json", "reduced": [],
            "why": "a test"})
    (tmp / "pirbench" / "traffic" / "batched8-written.json").write_text(
        json.dumps(dict(batched8, rows="written")))
    for cfg, mix in ((EIGHTH, "batched8-written"), (EIGHTH, "batched8"),
                     (wrong, "batched8-written")):
        name = f"{cfg['name']}.{mix}"
        bench["workloads"].append({"name": name, "config": cfg["name"],
                                   "traffic": mix, "chips": 1,
                                   "why": "a test"})
        bench["end_to_end"][0]["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp)


def test_partial_fill_is_compact_and_correct(root, capsys):
    r = run_cell("spiral-1gib-eighth-test.batched8-written", 3000000043,
                 SECONDS, False, root=root, cpu_tiny=True)
    log = capsys.readouterr().err
    assert "bucket filled (32 rows)" in log
    assert "layouts after each flush ['compact']" in log
    assert r["correct"] is True, log[-3000:]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["requests_not_right"]["value"] == 0


def test_unwritten_rows_read_back_as_zeros(root, capsys):
    """A mix over every row of the partly filled bucket reads rows the fill
    never wrote; each is judged against zeros."""
    r = run_cell("spiral-1gib-eighth-test.batched8", 3000000047, SECONDS,
                 False, root=root, cpu_tiny=True)
    assert r["correct"] is True, capsys.readouterr().err[-3000:]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_on_the_compact_index_comes_out_not_correct(root, fault):
    r = run_cell("spiral-1gib-eighth-test.batched8-written", 3000000053,
                 SECONDS, False, root=root, cpu_tiny=True,
                 fault=FAULTS[fault]())
    assert r["correct"] is False
    assert r["checks"]["requests_not_right"]["value"] == r["failed"] > 0
    if fault == "low_limb":
        assert r["failed"] == r["attempted"]


def test_wrong_expected_layout_raises_before_the_load(root):
    with pytest.raises(RuntimeError, match="the configuration expects"):
        run_cell("spiral-1gib-eighth-wrong.batched8-written", 3000000059,
                 SECONDS, False, root=root, cpu_tiny=True)
