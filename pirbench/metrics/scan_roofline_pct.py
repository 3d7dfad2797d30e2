"""Kernels (csrc/scan.cu, kernel C): the least time the dense scans of the
profiled slice's dispatches need (pirbench/harness/work.py, from each
dispatch's query count) over the device time of the scan kernels they
launched."""


def read(view):
    t = view.trace
    if t is None:
        return None
    names = view.kernel_names("scan")
    least = spent = 0.0
    for d in t.dispatches:
        us, n = d.kernel_us(names)
        if n:
            least += view.work.scan_least_s(view.params, d.nq)
            spent += us / 1e6
    return 100.0 * least / spent if spent > 0 else None
