"""Device: the share of the profiled slice in which the card is idle while
the coalescer's window is open (the program's ``coalescer.window`` spans,
put on the trace's clock by pirbench/harness/program_spans.py)."""

from pirbench.harness import program_spans


def read(view):
    ot = program_spans.on_trace(view)
    if ot is None:
        return None
    return program_spans.idle_share_pct(
        view.trace, ot.named({program_spans.WINDOW}))
