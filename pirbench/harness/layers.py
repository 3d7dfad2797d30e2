"""What a per-layer metric's reader is handed: the counters, spans and
trace of a traced run, and the yardstick to hold them against."""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import work
from .trace import TraceView, hand_kernel_names


@dataclass
class LayerView:
    """``counters``: the coalescer's counters (/metrics ``read_coalescer``)
    differenced over the counted part of the window; ``spans``: the engine
    dispatches of that part, (t0, t1, nq, fetch t0, fetch t1) host seconds;
    ``trace``: the profiled slice, or None; ``params``: the bucket's params
    JSON; ``csrc``: the program's CUDA sources (kernel names)."""
    counters: dict | None
    spans: list
    trace: TraceView | None
    params: dict
    csrc: str

    work = work

    def kernel_names(self, stem: str) -> set[str]:
        """The hand kernels of the program's ``csrc/<stem>.cu``."""
        return hand_kernel_names(self.csrc, stem)


def csrc_dir(root: str) -> str:
    return os.path.join(root, "sdk_tpu_torch", "csrc")
