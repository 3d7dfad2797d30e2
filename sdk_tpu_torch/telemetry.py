"""Per-stage serving metrics and profiling hooks.

The reference instruments every pipeline stage with ad-hoc Instant::now()
prints (lib/server/src/server.rs:66-84, bin/server.rs:104,138) and exposes
loading_time_us in HTTP responses. Here: a lightweight stage-timer registry
the servers publish via /metrics, plus an opt-in torch.profiler trace
capture (``profile_trace``, the counterpart of sdk_tpu.telemetry's
jax.profiler hook; tools/profile_trace_torch.py drives it and reads the
trace).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class StageTimers:
    """Aggregated wall-time counters per pipeline stage."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total_us: dict[str, int] = defaultdict(int)
        self._count: dict[str, int] = defaultdict(int)
        self._last_us: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            us = int((time.perf_counter() - t0) * 1e6)
            with self._lock:
                self._total_us[name] += us
                self._count[name] += 1
                self._last_us[name] = us

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
