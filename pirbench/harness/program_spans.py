"""The program's own records of the read path, for the per-layer readers.

The port's tracer (``sdk_tpu_torch.telemetry.GLOBAL_TIMERS``) keeps, in the
run's process, a ring of span records (name, t0_ns, t1_ns, thread, span,
parent, trace, count) on CLOCK_MONOTONIC, the clock of the benchmark's
dispatch spans (service.DispatchSpans, ``time.monotonic``). A program
without the ring (one older than it) gives nothing, and so do the readers.

``counted(view)``: the records of the dispatches that
``dispatch_host_ms_per_read.batched`` counts: the program's
``engine.dispatch`` spans inside the interval from the first to the last of
``view.spans`` (the same clock: nothing to map), with the records in their
traces (bucket, engine, device) and the requests linked to them.

``on_trace(view)``: the records with the offset that puts them on the
trace's clock (us). It is found by matching the program's
``engine.dispatch`` spans to the slice's ``view.trace.dispatches``, the
benchmark's span around the same call: the program's span lies inside the
benchmark's, so each match bounds the offset from below and from above.
The offset is the middle of the bounds all matches leave, and the residual
(logged) half their distance.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass

from .trace import clip, union_us

DISPATCH = "engine.dispatch"
HANDLER = "http.private_read"
WINDOW = "coalescer.window"
# host spans doing work: a handler's self time, the bucket's, the enqueue
# and the bytes (the waits coalescer.wait, bucket.lock_wait and
# engine.fetch are not work)
WORKING = ("bucket.flush", "bucket.parse", DISPATCH, "engine.to_bytes")
MATCH_SLACK_US = 1000.0    # a candidate offset's matches may miss by this


def log(msg: str) -> None:
    print(f"[pirbench] {msg}", file=sys.stderr, flush=True)


def program_records():
    """The ring of the program's tracer, or None without one."""
    try:
        from sdk_tpu_torch.telemetry import GLOBAL_TIMERS
    except ImportError:
        return None
    records = getattr(GLOBAL_TIMERS, "records", None)
    return None if records is None else records()


@dataclass
class Counted:
    dispatches: list     # engine.dispatch records
    records: list        # every record in their traces
    handlers: list       # http.private_read records linked to them
    children: dict       # span id -> its child records

    @property
    def queries(self) -> int:
        return sum(r.count for r in self.dispatches)


def _children(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.parent, []).append(r)
    return out


def counted(view, records=None) -> Counted | None:
    records = program_records() if records is None else records
    if not records or not view.spans:
        return None
    lo = int(min(s[0] for s in view.spans) * 1e9)
    hi = int(max(s[1] for s in view.spans) * 1e9)
    disp = [r for r in records if r.name == DISPATCH
            and r.t0_ns >= lo and r.t1_ns <= hi]
    if not disp:
        return None
    traces = {r.trace for r in disp}
    kids = _children(records)
    handlers = [r for r in records if r.name == HANDLER and (
        r.trace in traces
        or any(k.trace in traces for k in kids.get(r.span, ())))]
    if len(disp) != len(view.spans):
        log(f"program spans: {len(disp)} engine.dispatch in the counted "
            f"part, {len(view.spans)} benchmark dispatch spans")
    return Counted(disp, [r for r in records if r.trace in traces],
                   handlers, kids)


def self_intervals(rec, children: dict) -> list:
    """The parts of a span (ns) that none of its child spans covers."""
    out, at = [], rec.t0_ns
    for c in sorted(children.get(rec.span, ()), key=lambda c: c.t0_ns):
        if c.t0_ns > at:
            out.append((at, min(c.t0_ns, rec.t1_ns)))
        at = max(at, c.t1_ns)
    if at < rec.t1_ns:
        out.append((at, rec.t1_ns))
    return out


def match_offset(dispatches: list, records: list):
    """(offset us: trace clock - program clock, residual us, matches) from
    the benchmark's dispatch spans on the trace's clock (``dispatches``,
    each with .span and .nq) and the program's records; None where none
    matches."""
    prog = sorted((r for r in records if r.name == DISPATCH),
                  key=lambda r: r.t0_ns)
    if not dispatches or not prog:
        return None
    starts = [r.t0_ns / 1e3 for r in prog]

    def inside(d, off: float, slack: float):
        k = bisect.bisect_left(starts, d.span[0] - off - slack)
        for r in prog[k:]:
            if r.t0_ns / 1e3 + off > d.span[1] + slack:
                break
            if (r.count == d.nq
                    and r.t1_ns / 1e3 + off <= d.span[1] + slack):
                return r
        return None

    best = []
    first = dispatches[0]
    for r in prog:
        if r.count != first.nq:
            continue
        off = first.span[0] - r.t0_ns / 1e3
        pairs = [(d, p) for d in dispatches
                 if (p := inside(d, off, MATCH_SLACK_US)) is not None]
        if len(pairs) > len(best):
            best = pairs
    if not best:
        return None
    # the program's span lies inside the benchmark's: w0 <= p0 + off and
    # p1 + off <= w1, so off lies in [w0 - p0, w1 - p1] for every pair
    lo = max(d.span[0] - p.t0_ns / 1e3 for d, p in best)
    hi = min(d.span[1] - p.t1_ns / 1e3 for d, p in best)
    return (lo + hi) / 2, abs(hi - lo) / 2, len(best)


@dataclass
class OnTrace:
    records: list
    children: dict
    offset_us: float     # trace clock - program clock

    def at(self, t0_ns: int, t1_ns: int) -> tuple:
        return (t0_ns / 1e3 + self.offset_us, t1_ns / 1e3 + self.offset_us)

    def named(self, names) -> list:
        return [self.at(r.t0_ns, r.t1_ns) for r in self.records
                if r.name in names]


def on_trace(view, records=None) -> OnTrace | None:
    """The program's records with the offset that puts them on the trace's
    clock, or None (no trace, no records, no match). Worked out once a
    view."""
    cached = getattr(view, "_program_on_trace", False)
    if cached is not False:
        return cached
    out = None
    records = program_records() if records is None else records
    t = view.trace
    if records and t is not None:
        m = match_offset(t.dispatches, records)
        if m is not None:
            off, residual, n = m
            log(f"program spans on the trace's clock: {n} of "
                f"{len(t.dispatches)} dispatches matched, offset {off:.1f} "
                f"us, residual {residual:.2f} us")
            out = OnTrace(records, _children(records), off)
    view._program_on_trace = out
    return out


def idle_intervals(t) -> list:
    """The stretches of the slice with nothing on the device (trace us):
    the walk of ``TraceView.idle_gaps``, which hands out only the longest
    gaps and without their places."""
    busy = sorted(clip([(e["ts"], e["ts"] + e["dur"]) for e in t.device],
                       t.t0, t.t1))
    gaps, end = [], t.t0
    for s, e in busy:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if end < t.t1:
        gaps.append((end, t.t1))
    return gaps


def merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: list, b: list) -> list:
    """Two lists of disjoint, sorted intervals -> their intersection."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: list, b: list) -> list:
    """Disjoint sorted intervals ``a`` minus disjoint sorted ``b``."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def working_intervals(ot: OnTrace) -> list:
    """Where a program host span does work (trace us): a handler's self
    time and the WORKING spans."""
    out = ot.named(WORKING)
    for r in ot.records:
        if r.name == HANDLER:
            out += [ot.at(s, e) for s, e in self_intervals(r, ot.children)]
    return merge(out)


def idle_share_pct(t, intervals: list) -> float:
    """% of the slice with the card idle inside ``intervals``."""
    return 100.0 * union_us(intersect(idle_intervals(t), merge(
        clip(intervals, t.t0, t.t1)))) / t.slice_us
