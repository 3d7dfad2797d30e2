"""Reading a torch.profiler Chrome trace of the served window.

``union_us``, ``hand_kernel_names`` and ``hand_name`` are frozen copies of
tools/profile_trace_torch.py at commit 1023d4a (the device's busy time is
the union of its activity intervals; a hand kernel is a ``__global__``
``*_kernel`` function of the port's CUDA sources).

The profiler records the device work of the thread that starts it; the
traced run's main thread starts it and makes every engine dispatch while
it runs (service.DispatchSpans.hold). The run times each dispatch and its
fetch on the host (``time.monotonic``) and opens and closes the profiled
slice with an annotation, each right after a host reading: the two map
host instants onto the trace's clock. A device operation belongs to the
dispatch whose host span holds the runtime call that launched it. The
copy of a dispatch's words back to the host, made by the fetch in a
handler thread, is not recorded.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
SLICE_START, SLICE_END = "pirbench.slice.start", "pirbench.slice.end"


def hand_kernel_names(csrc: str, stem: str = "*") -> set[str]:
    """The ``__global__`` functions of the port's CUDA sources (each named
    ``*_kernel``); ``stem`` picks one source, e.g. "scan"."""
    names = set()
    for path in glob.glob(os.path.join(csrc, f"{stem}.cu")):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"__global__", text):
            k = re.search(r"\b(\w+_kernel)\s*\(", text[m.end():m.end() + 400])
            if k:
                names.add(k.group(1))
    return names


def hand_name(kernel: str, names: set[str]) -> str | None:
    """The hand kernel a trace's kernel name is, or None for PyTorch's."""
    if "at::" in kernel or "cub::" in kernel:
        return None
    for m in re.finditer(r"\b(\w+_kernel)\b", kernel):
        if m.group(1) in names:
            return m.group(1)
    return None


def union_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def clip(intervals, t0: float, t1: float) -> list:
    return [(max(s, t0), min(e, t1)) for s, e in intervals if s < t1 and e > t0]


@dataclass
class Dispatch:
    """One engine dispatch seen in the slice, on the trace's clock (us)."""
    nq: int
    span: tuple
    fetch: tuple | None
    ops: list = field(default_factory=list)     # its device events

    def busy_us(self) -> float:
        return union_us([(e["ts"], e["ts"] + e["dur"]) for e in self.ops])

    def kernel_us(self, names: set[str]) -> tuple[float, int]:
        """Device time and count of its kernels that are among ``names``."""
        ks = [e for e in self.ops if e["cat"] == "kernel"
              and hand_name(e["name"], names) is not None]
        return sum(e["dur"] for e in ks), len(ks)


class TraceView:
    """The profiled slice: every device event in it, the dispatches whose
    host spans (dispatch and fetch) lie inside it, and their events."""

    def __init__(self, trace: dict, anchors_host: tuple, spans: list):
        evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        marks = {e["name"]: e["ts"] for e in evs
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in (SLICE_START, SLICE_END)}
        if len(marks) != 2:
            raise ValueError(f"slice marks in the trace: {sorted(marks)}")
        self.t0, self.t1 = marks[SLICE_START], marks[SLICE_END]
        offset = self.t0 - anchors_host[0] * 1e6
        # how far the second anchor lies from where the first puts it
        self.anchor_skew_us = self.t1 - (anchors_host[1] * 1e6 + offset)
        self.device = sorted((e for e in evs if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        calls = {e["args"]["correlation"]: e for e in evs
                 if e.get("cat") in CALL_CATS
                 and "correlation" in e.get("args", {})}
        self.dispatches: list[Dispatch] = []
        for d_t0, d_t1, nq, f_t0, f_t1 in spans:
            if f_t1 is None:
                continue
            span = (d_t0 * 1e6 + offset, d_t1 * 1e6 + offset)
            fetch = (f_t0 * 1e6 + offset, f_t1 * 1e6 + offset)
            if span[0] >= self.t0 and fetch[1] <= self.t1:
                self.dispatches.append(Dispatch(nq, span, fetch))
        self.dispatches.sort(key=lambda d: d.span[0])
        starts = [d.span[0] for d in self.dispatches]
        for e in self.device:
            call = calls.get(e.get("args", {}).get("correlation"))
            if call is None:
                continue
            k = bisect.bisect_right(starts, call["ts"]) - 1
            if k >= 0 and call["ts"] <= self.dispatches[k].span[1]:
                self.dispatches[k].ops.append(e)
        self.slice_us = self.t1 - self.t0
        self.busy_us = union_us(clip(
            [(e["ts"], e["ts"] + e["dur"]) for e in self.device],
            self.t0, self.t1))

    def op_seconds(self, names: set[str], top: int = 10) -> list:
        """The device operations that took most time in the slice, by name
        (a hand kernel by its function, others by their first 80
        characters), as [name, seconds]."""
        total: dict[str, float] = {}
        for e in self.device:
            for s, t in clip([(e["ts"], e["ts"] + e["dur"])], self.t0,
                             self.t1):
                name = hand_name(e["name"], names) or e["name"][:80]
                total[name] = total.get(name, 0.0) + (t - s) / 1e6
        return sorted(([k, v] for k, v in total.items() if v > 0),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches of the slice with nothing on the device,
        each named by what the host was doing then: enqueueing a dispatch,
        waiting in a fetch, or neither (the HTTP handlers and the
        coalescing window)."""
        busy = sorted(clip([(e["ts"], e["ts"] + e["dur"]) for e in self.device],
                           self.t0, self.t1))
        gaps, end = [], self.t0
        for s, e in busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.t1:
            gaps.append((end, self.t1))
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (g0 + g1) / 2
            what = "no dispatch or fetch (HTTP, window)"
            for d in self.dispatches:
                if d.span[0] <= mid <= d.span[1]:
                    what = f"dispatch enqueue (nq={d.nq})"
                    break
                if d.fetch[0] <= mid <= d.fetch[1]:
                    what = f"fetch wait (nq={d.nq})"
            out.append([what, (g1 - g0) / 1e6])
        return out


def load_trace(trace_dir: str) -> dict:
    paths = glob.glob(os.path.join(trace_dir, "*.json"))
    if len(paths) != 1:
        raise ValueError(f"{len(paths)} traces in {trace_dir}")
    with open(paths[0]) as f:
        return json.load(f)
