"""The port's tracer (``GLOBAL_TIMERS``) and its profiling hook.

The reference instruments every pipeline stage with ad-hoc Instant::now()
prints (lib/server/src/server.rs:66-84, bin/server.rs:104,138) and exposes
loading_time_us in HTTP responses. Here one tracer records the served read
path from the inside:

- a span (``GLOBAL_TIMERS.span(name, count, trace)``, a ``with`` block)
  records its name, start and end on ``time.monotonic_ns()``
  (CLOCK_MONOTONIC, the clock ``time.monotonic()`` reads), its thread, its
  own id, the id of the span that caused it (the innermost span open on
  the thread when it started, 0 for none), a trace id and a count (queries
  or requests). A span takes the trace id of the span that caused it,
  unless it is given one; a span with neither starts a trace of its own
  (its id). So the spans of one request share its trace, and the spans of
  one coalesced dispatch share the dispatch's (``new_trace``);
- the finished records go into a ring of the last ``RING_RECORDS``
  (``records()``), written in place into preallocated 64-bit slots, so
  recording keeps no new object alive and never sets off a pass of the
  garbage collector (whose passes hold every thread), and into per-name
  totals, which ``/metrics`` reports as
  ``stages`` (``snapshot()``: count, total, mean and last microseconds);
- ``add`` records what is not a host span: the dispatch's device stages
  (``device.*``), timed with CUDA events and resolved once the fetch has
  the batch's words.

The spans of the read path, outermost first (PERF.md §3 names the metric
that reads each): ``http.private_read`` (server/http.py, a /private-read
request from its body read to its response written);
``coalescer.window`` (the leader's sleep), ``coalescer.wait`` (a
follower's wait, in the dispatch's trace), ``coalescer.batch`` (the
leader's work on the batch after the window); ``bucket.lock_wait``,
``bucket.flush``, ``bucket.parse`` (server/kv_server.py);
``engine.dispatch`` (the host enqueue) with ``engine.index`` inside it (a
zero-length record; count: the rows the scanned index holds),
``engine.fetch`` (the blocking copy of the words), ``engine.to_bytes``
(ops/server.py); and on a card
``device.expand``, ``device.scan``, ``device.fold`` (``device.scan_fold``
on a mesh), ``device.pack``. The tracer starts no thread and writes no
file; a span costs a few microseconds of host time.

``profile_trace`` is the opt-in torch.profiler capture (the counterpart of
sdk_tpu.telemetry's jax.profiler hook; tools/profile_trace_torch.py drives
it and reads the trace).
"""

from __future__ import annotations

import array
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

# the ring's size: a 35 s run of the no-window service at ~150 single
# reads a second records ~11 a read (58k); 64 bytes a record, 4 MiB
RING_RECORDS = 1 << 16


class SpanRecord(NamedTuple):
    """A finished span (or device stage): times in ns on CLOCK_MONOTONIC.
    A ``device.*`` record's duration is its stage's stream time, but its
    placement is made up (the stages laid back to back, the last ending
    when they were resolved): read only its duration."""
    name: str
    t0_ns: int
    t1_ns: int
    thread: int
    span: int       # its own id
    parent: int     # the span that caused it, 0 for none
    trace: int      # the request or dispatch it belongs to
    count: int      # queries or requests, 0 where neither applies


_WIDTH = len(SpanRecord._fields)


class Span:
    """An open span; ``count`` may be set while it is open."""
    __slots__ = ("_timers", "name", "count", "trace", "span", "parent",
                 "t0_ns")

    def __init__(self, timers: "StageTimers", name: str, count: int,
                 trace: int | None):
        self._timers = timers
        self.name = name
        self.count = count
        self.trace = trace

    def __enter__(self) -> "Span":
        stack = self._timers._stack()
        top = stack[-1] if stack else None
        self.span = next(self._timers._ids)
        self.parent = top.span if top is not None else 0
        if self.trace is None:
            self.trace = top.trace if top is not None else self.span
        stack.append(self)
        self.t0_ns = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic_ns()
        self._timers._stack().pop()
        self._timers._record((
            self.name, self.t0_ns, t1, threading.get_ident(), self.span,
            self.parent, self.trace, self.count))


class StageTimers:
    """Spans of the served path: a bounded ring of records and per-name
    totals (module docstring)."""

    def __init__(self, ring: int = RING_RECORDS):
        self._lock = threading.Lock()
        self._total_us: dict[str, int] = defaultdict(int)
        self._count: dict[str, int] = defaultdict(int)
        self._last_us: dict[str, int] = {}
        # the ring: a record's fields in _WIDTH slots, its name as an index
        # into _names; _written records since the start
        self._ring_len = ring
        self._slots = array.array("Q", bytes(8 * _WIDTH * ring))
        self._written = 0
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, count: int = 0,
             trace: int | None = None) -> Span:
        return Span(self, name, count, trace)

    def new_trace(self) -> int:
        """A fresh trace id (one coalesced dispatch's)."""
        return next(self._ids)

    def add(self, name: str, t0_ns: int, t1_ns: int, parent: int = 0,
            trace: int = 0, count: int = 0) -> None:
        """Record a finished interval that was not a span of this thread
        (a device stage: see SpanRecord), or a zero-length one that carries
        a count (``engine.index``)."""
        self._record((name, t0_ns, t1_ns, threading.get_ident(),
                      next(self._ids), parent, trace, count))

    def _record(self, rec: tuple) -> None:
        name = rec[0]
        us = (rec[2] - rec[1]) // 1000
        with self._lock:
            nid = self._name_ids.get(name)
            if nid is None:
                nid = self._name_ids[name] = len(self._names)
                self._names.append(name)
            at = self._written % self._ring_len * _WIDTH
            self._slots[at] = nid
            for k in range(1, _WIDTH):
                self._slots[at + k] = rec[k]
            self._written += 1
            self._total_us[name] += us
            self._count[name] += 1
            self._last_us[name] = us

    def records(self) -> list[SpanRecord]:
        """The ring's records, oldest first."""
        with self._lock:
            slots, written = self._slots[:], self._written
            names = list(self._names)
        out = []
        for n in range(max(0, written - self._ring_len), written):
            at = n % self._ring_len * _WIDTH
            out.append(SpanRecord(names[slots[at]],
                                  *slots[at + 1:at + _WIDTH]))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                name: {
                    "count": self._count[name],
                    "total_us": self._total_us[name],
                    "mean_us": self._total_us[name] // max(1, self._count[name]),
                    "last_us": self._last_us.get(name, 0),
                }
                for name in self._total_us
            }


GLOBAL_TIMERS = StageTimers()


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: bool | None = None):
    """Capture a torch.profiler trace of the enclosed block and write it as
    a Chrome / Perfetto trace (``trace_<pid>_<ns>.json``, open it in
    ui.perfetto.dev or chrome://tracing) under ``log_dir``. It records CPU
    activity, and the card's kernels and copies too when ``cuda`` is true
    (default: a CUDA device is present, i.e. the traced tensors live on a
    card). Yields the profiler; the trace's path is its ``trace_path``
    once the block has exited."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
