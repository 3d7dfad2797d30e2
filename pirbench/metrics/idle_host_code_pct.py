"""Device: the share of the profiled slice in which the card is idle, no
coalescing window is open, and a program host span does work: a handler's
self time, the bucket's flush and parse, the enqueue, the bytes
(pirbench/harness/program_spans.py; the waits do not count). What is left
of device_idle_pct after this and idle_window_pct is time in which no
program code runs: the network and the clients."""

from pirbench.harness import program_spans


def read(view):
    ot = program_spans.on_trace(view)
    if ot is None:
        return None
    window = program_spans.merge(ot.named({program_spans.WINDOW}))
    return program_spans.idle_share_pct(view.trace, program_spans.subtract(
        program_spans.working_intervals(ot), window))
