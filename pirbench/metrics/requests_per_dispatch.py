"""HTTP service (server/http.py ReadCoalescer): /private-read requests
merged into one engine dispatch, from the coalescer's own counters
(/metrics ``read_coalescer``) differenced over the counted part of the
window. Nothing to read without a window: each request is then its own
dispatch and the coalescer counts nothing."""


def read(view):
    c = view.counters
    if not c or c.get("batches", 0) <= 0:
        return None
    return c["requests"] / c["batches"]
