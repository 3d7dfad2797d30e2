"""Kernels (csrc/scan_compact.cu, kernel I): the least time the compact
scans of the profiled slice's dispatches need
(pirbench/harness/work_compact.py, from each dispatch's query count and the
rows the index holds) over the device time of kernel I's launches. The rows
held are the count of the program's ``engine.index`` records in the counted
dispatches (pirbench/harness/program_spans.py), the fewest where they
differ. Nothing to read without those records (a program without them) or
without kernel I (a dense index)."""

from pirbench.harness import program_spans, work_compact

INDEX = "engine.index"


def read(view):
    t = view.trace
    c = program_spans.counted(view)
    if t is None or c is None:
        return None
    held = [r.count for r in c.records if r.name == INDEX]
    if not held or min(held) <= 0:
        return None
    rows = min(held)
    names = view.kernel_names("scan_compact")
    least = spent = 0.0
    for d in t.dispatches:
        us, n = d.kernel_us(names)
        if n:
            least += work_compact.scan_compact_least_s(view.params, d.nq,
                                                       rows)
            spent += us / 1e6
    return 100.0 * least / spent if spent > 0 else None
