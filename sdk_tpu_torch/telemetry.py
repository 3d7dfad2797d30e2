"""Per-stage serving metrics and profiling hooks.

The reference instruments every pipeline stage with ad-hoc Instant::now()
prints (lib/server/src/server.rs:66-84, bin/server.rs:104,138) and exposes
loading_time_us in HTTP responses. Here: a lightweight stage-timer registry
the servers publish via /metrics. (Copied from sdk_tpu.telemetry without its
profiler trace hook, which is JAX's; a torch.profiler counterpart is not
ported yet.)
"""

from __future__ import annotations

import contextlib
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

