"""Device: milliseconds the card is busy per query, over the dispatches
whose host spans lie in the profiled slice: the union of the intervals of
every kernel, copy and memset each one launched, and the copy of its words
back, divided by the queries they carried."""


def read(view):
    t = view.trace
    if t is None:
        return None
    ds = [d for d in t.dispatches if d.ops]
    nq = sum(d.nq for d in ds)
    if not nq:
        return None
    return sum(d.busy_us() for d in ds) / 1e3 / nq
