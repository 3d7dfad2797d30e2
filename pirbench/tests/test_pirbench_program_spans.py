"""The readers of the program's own spans (pirbench/harness/program_spans.py)
on made-up program records and a made-up trace: the counted dispatches'
handler, bucket, enqueue and stage times, the clock match onto the trace,
and the idle shares it splits; and nothing to read from a program without
the tracer's ring."""

from __future__ import annotations

import os

import pytest

from pirbench.harness import program_spans
from pirbench.harness.cells import load_reader
from pirbench.harness.layers import LayerView, csrc_dir
from pirbench.harness.trace import SLICE_END, SLICE_START, TraceView
from sdk_tpu_torch.telemetry import SpanRecord

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ANCHOR = 100.0          # host seconds at the slice's start (trace ts 5e6 us)
BASE = 5e6
READERS = ("handler_host_ms_per_request", "bucket_host_ms_per_read",
           "engine_enqueue_ms_per_read", "expand_stage_ms_per_read",
           "fold_stage_ms_per_read", "idle_window_pct", "idle_host_code_pct")


class Records:
    def __init__(self):
        self.out = []

    def add(self, name, t0, t1, span, parent, trace, count=0):
        """Host seconds -> a record on the monotonic ns clock."""
        self.out.append(SpanRecord(name, round(t0 * 1e9), round(t1 * 1e9),
                                   1, span, parent, trace, count))


def counted_dispatch(rec: Records, b: float, nq: int, ids: int) -> list:
    """A coalesced dispatch of two requests enqueued at host second ``b``:
    the leader's handler self time 3 ms, the follower's 2.5; flush 0.4 ms
    and two parses of 1.5; the enqueue 0.18 ms inside the benchmark's
    0.2 ms span; expand 0.2 ms and fold 0.4 ms of stream time a query.
    Returns the benchmark's span."""
    tr = ids + 100
    rec.add("http.private_read", b - .040, b + .012, ids + 1, 0, ids + 1, 1)
    rec.add("coalescer.window", b - .039, b - .014, ids + 2, ids + 1, tr)
    rec.add("coalescer.batch", b - .014, b + .010, ids + 3, ids + 1, tr, 2)
    rec.add("bucket.lock_wait", b - .014, b - .0139, ids + 4, ids + 3, tr)
    rec.add("bucket.flush", b - .0139, b - .0135, ids + 5, ids + 3, tr)
    rec.add("bucket.parse", b - .0135, b - .012, ids + 6, ids + 3, tr, nq // 2)
    rec.add("bucket.parse", b - .012, b - .0105, ids + 7, ids + 3, tr, nq // 2)
    rec.add("engine.dispatch", b + 1e-5, b + 1.9e-4, ids + 8, ids + 3, tr, nq)
    rec.add("engine.fetch", b + 3e-4, b + .006, ids + 9, ids + 3, tr, nq)
    rec.add("engine.to_bytes", b + .006, b + .007, ids + 10, ids + 3, tr, nq)
    rec.add("device.expand", b + .001, b + .001 + 2e-4 * nq, ids + 11,
            ids + 8, tr, nq)
    rec.add("device.fold", b + .003, b + .003 + 4e-4 * nq, ids + 12,
            ids + 8, tr, nq)
    rec.add("http.private_read", b - .038, b + .011, ids + 13, 0, ids + 13, 1)
    rec.add("coalescer.wait", b - .037, b + .0095, ids + 14, ids + 13, tr)
    return [b, b + 2e-4, nq, b + 3e-4, b + .006]


def sliced_dispatches(rec: Records) -> list:
    """Two dispatches in the slice (host 100.000-100.100 s): C (8 queries;
    the program's enqueue 10 us inside the benchmark's span at each end)
    and D (16; 5 and 30 us). Returns the benchmark's spans."""
    s = ANCHOR
    rec.add("http.private_read", s + .027, s + .050, 301, 0, 301, 1)
    rec.add("coalescer.window", s + .028, s + .038, 302, 301, 300)
    rec.add("coalescer.batch", s + .038, s + .049, 303, 301, 300, 1)
    rec.add("bucket.lock_wait", s + .038, s + .0381, 304, 303, 300)
    rec.add("bucket.flush", s + .0381, s + .0385, 305, 303, 300)
    rec.add("bucket.parse", s + .0385, s + .040, 306, 303, 300, 8)
    rec.add("engine.dispatch", s + .04001, s + .04019, 307, 0, 307, 8)
    rec.add("engine.fetch", s + .0403, s + .044, 308, 303, 307, 8)
    rec.add("engine.to_bytes", s + .044, s + .045, 309, 303, 307, 8)
    rec.add("http.private_read", s + .0755, s + .0998, 401, 0, 401, 1)
    rec.add("coalescer.window", s + .076, s + .080, 402, 401, 400)
    rec.add("coalescer.batch", s + .080, s + .0995, 403, 401, 400, 2)
    rec.add("bucket.lock_wait", s + .080, s + .0801, 404, 403, 400)
    rec.add("bucket.flush", s + .0801, s + .0802, 405, 403, 400)
    rec.add("bucket.parse", s + .0802, s + .0804, 406, 403, 400, 16)
    rec.add("engine.dispatch", s + .090005, s + .09017, 407, 0, 407, 16)
    rec.add("engine.fetch", s + .0903, s + .099, 408, 403, 407, 16)
    rec.add("engine.to_bytes", s + .099, s + .0995, 409, 403, 407, 16)
    rec.add("http.private_read", s + .0785, s + .083, 411, 0, 411, 1)
    rec.add("coalescer.wait", s + .079, s + .0825, 412, 411, 400)
    return [[s + .040, s + .0402, 8, s + .0403, s + .044],
            [s + .090, s + .0902, 16, s + .0903, s + .099]]


def made_up_run():
    """The program's records, the counted benchmark spans and the trace:
    the card busy 0-30, 40.1-75 and 85-100 ms of the 100 ms slice (idle
    20.1%)."""
    rec = Records()
    spans = [counted_dispatch(rec, 99.0, 8, 0),
             counted_dispatch(rec, 99.3, 16, 1000)]
    sliced = sliced_dispatches(rec)
    evs = [{"ph": "X", "cat": "user_annotation", "name": name, "ts": t,
            "dur": 2} for name, t in ((SLICE_START, BASE),
                                      (SLICE_END, BASE + 100_000))]
    evs += [{"ph": "X", "cat": "kernel", "name": "scan_kernel", "ts": BASE + s,
             "dur": e - s} for s, e in ((0, 30_000), (40_100, 75_000),
                                        (85_000, 100_000))]
    tv = TraceView({"traceEvents": evs}, (ANCHOR, ANCHOR + 0.1), sliced)
    return rec.out, LayerView({}, spans, tv, {}, csrc_dir(ROOT))


def test_readers_on_made_up_records(monkeypatch):
    records, view = made_up_run()
    monkeypatch.setattr(program_spans, "program_records", lambda: records)

    def read(name):
        return load_reader(ROOT, name + ".batched")(view)

    assert read("handler_host_ms_per_request") == pytest.approx(2.75)
    assert read("bucket_host_ms_per_read") == pytest.approx(2 * 3.4 / 24)
    assert read("engine_enqueue_ms_per_read") == pytest.approx(2 * 0.18 / 24)
    assert read("expand_stage_ms_per_read") == pytest.approx(0.2)
    assert read("fold_stage_ms_per_read") == pytest.approx(0.4)
    # the match puts the program 2.5 us late (C's 10 us and D's 5 us lags
    # bound it), so the shares are exact to 0.0025% of the slice
    window = read("idle_window_pct")
    host = read("idle_host_code_pct")
    assert window == pytest.approx(12.0, abs=0.01)
    assert host == pytest.approx(3.29, abs=0.01)
    assert window + host <= read("device_idle_pct")
    assert read("device_idle_pct") == pytest.approx(20.1)


def test_clock_match_and_its_residual():
    records, view = made_up_run()
    off, residual, n = program_spans.match_offset(view.trace.dispatches,
                                                  records)
    truth = BASE - ANCHOR * 1e6
    assert n == 2 and residual < 50
    assert residual == pytest.approx(7.5, abs=1e-3)
    assert abs(off - truth) <= residual


def test_nothing_to_read_from_a_program_without_the_ring(monkeypatch):
    _, view = made_up_run()
    monkeypatch.setattr(program_spans, "program_records", lambda: None)
    for name in READERS:
        assert load_reader(ROOT, name + ".batched")(view) is None, name
