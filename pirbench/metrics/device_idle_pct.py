"""Device: the share of the profiled slice in which no kernel, copy or
memset runs on the card, 100 x (1 - union of their intervals / slice)."""


def read(view):
    t = view.trace
    if t is None or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.slice_us)
