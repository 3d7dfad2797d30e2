"""HTTP service (server/http.py, the handler): host milliseconds a
/private-read request spends in the handler's own work (body read, JSON and
base64 decode, base64 and JSON encode, the write), the self time of the
program's ``http.private_read`` span (its span minus the coalescer's spans
inside it), over the requests the counted dispatches served
(pirbench/harness/program_spans.py)."""

from pirbench.harness import program_spans


def read(view):
    c = program_spans.counted(view)
    if c is None or not c.handlers:
        return None
    ns = sum(e - s for h in c.handlers
             for s, e in program_spans.self_intervals(h, c.children))
    return ns / 1e6 / len(c.handlers)
