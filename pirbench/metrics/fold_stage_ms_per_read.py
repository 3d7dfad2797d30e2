"""Stages (ops/server.py _dispatch, ops/shard.py fold_columns): stream
milliseconds of the fold stage (``device.fold``: kernel F's rounds and
their prologue's torch ops, between two CUDA events on the engine's
stream) per query of the counted dispatches
(pirbench/harness/program_spans.py). Nothing to read without the events (a
program without them, or no card)."""

from pirbench.harness import program_spans

STAGE = "device.fold"


def read(view):
    c = program_spans.counted(view)
    if c is None:
        return None
    recs = [r for r in c.records if r.name == STAGE]
    nq = sum(r.count for r in recs)
    return sum(r.t1_ns - r.t0_ns for r in recs) / 1e6 / nq if nq else None
