"""Bucket server (server/kv_server.py): host milliseconds of the program's
``bucket.flush`` and ``bucket.parse`` spans, under the bucket's lock before
each dispatch, per query of the counted dispatches
(pirbench/harness/program_spans.py)."""

from pirbench.harness import program_spans


def read(view):
    c = program_spans.counted(view)
    if c is None:
        return None
    ns = sum(r.t1_ns - r.t0_ns for r in c.records
             if r.name in ("bucket.flush", "bucket.parse"))
    return ns / 1e6 / c.queries
