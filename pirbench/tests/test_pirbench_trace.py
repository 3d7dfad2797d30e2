"""The trace reading and the per-layer readers on a made-up trace: which
device work belongs to which dispatch, the slice's busy share, and the
rooflines against pirbench/harness/work.py."""

from __future__ import annotations

import os

import pytest

from pirbench.harness import work
from pirbench.harness.cells import load_reader
from pirbench.harness.layers import LayerView, csrc_dir
from pirbench.harness.trace import SLICE_END, SLICE_START, TraceView, union_us

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PARAMS = {"n": 2, "nu_1": 9, "nu_2": 6, "p": 256, "q2_bits": 22, "t_gsw": 7,
          "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 4}
ANCHOR = 100.0          # host seconds at the slice's start (trace ts 5e6 us)
BASE = 5e6
MAIN, SERVER = 11, 12   # the main thread, a handler thread


def host(t_us: float) -> float:
    """Host seconds of a trace instant."""
    return ANCHOR + (t_us - BASE) / 1e6


def made_up_trace():
    """A 100 ms slice holding two dispatches (8 and 16 queries), each a
    scan, two fold rounds and a torch kernel, then a copy back from another
    thread (not attributed), and one dispatch that started before the
    slice."""
    evs = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t,
            "dur": 2, "tid": MAIN}
           for name, t in ((SLICE_START, BASE), (SLICE_END, BASE + 100_000))]
    corr = iter(range(1, 1000))

    def launch(at, name, start, dur, cat="kernel"):
        c = next(corr)
        evs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                    "ts": at, "dur": 5, "tid": SERVER,
                    "args": {"correlation": c}})
        evs.append({"ph": "X", "cat": cat, "name": name, "ts": start,
                    "dur": dur, "args": {"correlation": c}})

    # before the slice: its kernel runs into it, it is not counted
    launch(BASE - 2000, "void scan_kernel<4>(int const*)", BASE, 1000)
    spans = [[host(BASE - 3000), host(BASE - 1000), 8, host(BASE - 900),
              host(BASE + 1500)]]
    for k, (nq, t) in enumerate([(8, 10_000), (16, 50_000)]):
        s = BASE + t
        launch(s + 10, "void scan_kernel<4>(int const*)", s + 100, 3000)
        launch(s + 20, "fold_round_kernel(long const*)", s + 3100, 1000)
        launch(s + 30, "fold_round_kernel(long const*)", s + 4100, 500)
        launch(s + 40, "void at::native::elementwise_kernel<128>()",
               s + 4600, 400)
        spans.append([host(s), host(s + 50), nq, host(s + 60),
                      host(s + 6000)])
        # the fetch's copy back, from another thread
        launch(s + 70, "Memcpy DtoH (Device -> Pageable)", s + 5100, 200,
               cat="gpu_memcpy")
    return {"traceEvents": evs}, spans


def test_dispatches_and_their_device_work():
    trace, spans = made_up_trace()
    tv = TraceView(trace, (ANCHOR, ANCHOR + 0.1), spans)
    assert [d.nq for d in tv.dispatches] == [8, 16]
    assert [len(d.ops) for d in tv.dispatches] == [4, 4]
    assert tv.dispatches[0].busy_us() == pytest.approx(4900)
    assert tv.slice_us == 100_000
    assert tv.anchor_skew_us == pytest.approx(0, abs=1e-6)
    assert tv.busy_us == pytest.approx(1000 + 2 * 5100)
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_readers_on_the_made_up_trace():
    trace, spans = made_up_trace()
    tv = TraceView(trace, (ANCHOR, ANCHOR + 0.1), spans)
    view = LayerView({"batches": 4, "requests": 10}, spans, tv, PARAMS,
                     csrc_dir(ROOT))

    def read(name):
        return load_reader(ROOT, name)(view)

    assert read("requests_per_dispatch") == 2.5
    assert read("device_ms_per_read") == pytest.approx(2 * 4.9 / 24)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 0.112))
    scan = work.scan_least_s(PARAMS, 8) + work.scan_least_s(PARAMS, 16)
    assert read("scan_roofline_pct") == pytest.approx(100 * scan / 6e-3)
    fold = work.fold_least_s(PARAMS, 8) + work.fold_least_s(PARAMS, 16)
    assert read("fold_roofline_pct") == pytest.approx(100 * fold / 3e-3)
    assert read("dispatch_host_ms_per_read") == pytest.approx(
        (2.0 + 0.05 + 0.05) / 32)
    assert tv.op_seconds({"scan_kernel", "fold_round_kernel"})[0] == [
        "scan_kernel", pytest.approx(7e-3)]
    gaps = tv.idle_gaps()
    assert gaps[0] == ["no dispatch or fetch (HTTP, window)",
                       pytest.approx(0.0447)]


def test_work_counts_at_the_bucket_shapes():
    # PERF.md's kernel table: C's bound at R = 2 and 32, F's whole fold at
    # NQ = 16 (1.09 ms) and its round 0 at NQ = 1 (0.0343 ms, 509 live)
    assert work.scan_least_s(PARAMS, 1) * 1e3 == pytest.approx(2.5792, rel=1e-3)
    assert work.scan_least_s(PARAMS, 16) * 1e3 == pytest.approx(2.8045,
                                                                rel=1e-3)
    assert work.fold_least_s(PARAMS, 16) * 1e3 == pytest.approx(1.0865,
                                                                rel=1e-3)
    assert work.fold_round_least_s(PARAMS, 1, 0) * 1e3 == pytest.approx(
        0.0343 * 512 / 509, rel=1e-2)
