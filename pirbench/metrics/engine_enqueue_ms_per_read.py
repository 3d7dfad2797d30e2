"""Engine (ops/server.py dispatch_queries_batched): host milliseconds of
the program's own ``engine.dispatch`` span, the enqueue, per query of the
counted dispatches (pirbench/harness/program_spans.py); the in-program twin
of dispatch_host_ms_per_read, which the benchmark's own span around the
call gives."""

from pirbench.harness import program_spans


def read(view):
    c = program_spans.counted(view)
    if c is None:
        return None
    return sum(r.t1_ns - r.t0_ns for r in c.dispatches) / 1e6 / c.queries
