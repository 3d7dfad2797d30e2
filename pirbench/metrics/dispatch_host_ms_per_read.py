"""Engine (ops/server.py dispatch_queries_batched): host milliseconds spent
in the call that enqueues a batch, per query it carries, from the
benchmark's span around each call in the counted part of the window (before
the profiler starts)."""


def read(view):
    nq = sum(r[2] for r in view.spans)
    if not nq:
        return None
    return sum(r[1] - r[0] for r in view.spans) * 1e3 / nq
