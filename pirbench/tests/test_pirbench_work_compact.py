"""Kernel I's yardstick (pirbench/harness/work_compact.py) and its reader
(scan_compact_roofline_pct) on made-up program records and a made-up trace,
and the compact cell spiral-1gib-eighth.batched end to end on the port's
plain CPU path (--cpu-tiny)."""

from __future__ import annotations

import json
import os

import pytest

from pirbench.harness import program_spans, work, work_compact
from pirbench.harness.cells import load_cell, load_reader
from pirbench.harness.layers import LayerView, csrc_dir
from pirbench.harness.trace import SLICE_END, SLICE_START, TraceView
from pirbench.run import run_cell
from sdk_tpu_torch.telemetry import SpanRecord

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CELL = "spiral-1gib-eighth.batched"
with open(os.path.join(ROOT, "pirbench", "configs",
                       "spiral-1gib-eighth.json")) as _f:
    PARAMS = json.load(_f)["params"]
HELD = 4096             # the cell's written rows
ANCHOR = 100.0          # host seconds at the slice's start (trace ts 5e6 us)
BASE = 5e6
I_NAME = "void scan_compact_kernel<4>(int const*)"
C_NAME = "void scan_resident_kernel<4>(int const*)"


@pytest.mark.parametrize("nq", [1, 8, 16, 48, 64])
def test_every_row_held_is_the_dense_count(nq):
    assert (work_compact.scan_compact_least_s(PARAMS, nq, 32768)
            == work.scan_least_s(PARAMS, nq))


def test_the_cell_dispatch():
    """4,096 rows held, a 48-query dispatch (R = 96 real columns): index
    1.07 GB, columns 0.81 GB, products 1.61 GB at 3.35 TB/s, against 0.42 ms
    of int8 operations: bytes bound it."""
    least = work_compact.scan_compact_least_s(PARAMS, 48, HELD)
    assert least * 1e3 == pytest.approx(1.0417, rel=1e-2)
    assert least * work.HBM_BYTES_PER_S == pytest.approx(
        1.073741824e9 + 0.805306368e9 + 1.610612736e9)
    ops = 2 * 1.073741824e9 * work.LIMBS * 96
    assert ops / work.INT8_OPS_PER_S * 1e3 == pytest.approx(0.4167, rel=1e-3)


def made_up_run(kernel: str, index_records: bool = True):
    """Two counted dispatches before the slice (program records, each with
    its engine.index record unless told otherwise) and two in it (8 and 16
    queries), each launching one ``kernel`` of 3 ms and a fold round."""
    recs, spans = [], []
    for k, (b, nq) in enumerate([(99.0, 48), (99.2, 48)]):
        ids = 10 * k + 1
        recs.append(SpanRecord("engine.dispatch", round(b * 1e9),
                               round((b + 2e-4) * 1e9), 1, ids, 0, ids, nq))
        if index_records:
            t = round((b + 1e-5) * 1e9)
            recs.append(SpanRecord("engine.index", t, t, 1, ids + 1, ids,
                                   ids, HELD))
        spans.append([b - 1e-5, b + 3e-4, nq, b + 4e-4, b + .02])
    evs = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t,
            "dur": 2} for name, t in ((SLICE_START, BASE),
                                      (SLICE_END, BASE + 100_000))]
    sliced = []
    for c, (nq, t) in enumerate([(8, 10_000), (16, 50_000)]):
        s = BASE + t
        for j, (name, start, dur) in enumerate([
                (kernel, 100, 3000), ("fold_round_kernel(long const*)",
                                      3100, 1000)]):
            corr = 10 * c + j + 1
            evs.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                        "ts": s + 10 + j, "dur": 5,
                        "args": {"correlation": corr}})
            evs.append({"ph": "X", "cat": "kernel", "name": name,
                        "ts": s + start, "dur": dur,
                        "args": {"correlation": corr}})
        h = ANCHOR + t / 1e6
        sliced.append([h, h + 5e-5, nq, h + 6e-5, h + .006])
    tv = TraceView({"traceEvents": evs}, (ANCHOR, ANCHOR + 0.1), sliced)
    return recs, LayerView({}, spans, tv, PARAMS, csrc_dir(ROOT))


def read_share(monkeypatch, records, view):
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    return load_reader(ROOT, "scan_compact_roofline_pct.batched")(view)


def test_reader_on_made_up_records(monkeypatch):
    records, view = made_up_run(I_NAME)
    least = sum(work_compact.scan_compact_least_s(PARAMS, nq, HELD)
                for nq in (8, 16))
    assert read_share(monkeypatch, records, view) == pytest.approx(
        100 * least / 6e-3)


@pytest.mark.parametrize("case", ["no_index_record", "no_kernel_i",
                                  "no_ring", "no_trace"])
def test_nothing_to_read(monkeypatch, case):
    """A program without the engine.index record (the parent's), a dense
    index (kernel C only), no tracer's ring, no trace: nothing to read."""
    records, view = made_up_run(C_NAME if case == "no_kernel_i" else I_NAME,
                                index_records=case != "no_index_record")
    if case == "no_ring":
        records = None
    if case == "no_trace":
        view.trace = None
    assert read_share(monkeypatch, records, view) is None


def test_the_cell_is_the_compact_layout():
    cell = load_cell(ROOT, CELL)
    assert cell.traffic.rows == "written" and cell.chips == 1
    assert cell.config["fill"]["expect"] == {"index_layout": "compact",
                                             "sparse_expansion": False}
    names = {m["name"] for m in cell.per_layer}
    assert "scan_compact_roofline_pct.batched" in names
    assert "scan_roofline_pct.batched" not in names


def test_the_cell_is_correct_on_the_cpu(capsys):
    r = run_cell(CELL, 3000000061, 20, False, cpu_tiny=True)
    log = capsys.readouterr().err
    assert "layouts after each flush ['compact']" in log
    assert r["correct"] is True, log[-3000:]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s.batched", "setup_s"}
