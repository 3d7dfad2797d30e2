"""Faults planted under the timed path, and the control. The benchmark's
own runs plant none: pirbench/control.py and the tests use them to show
that ``correct`` comes out false.

    low_limb      the control: the index's lowest 7-bit limb dropped after
                  the fill, in the dense tensor or in the compact index's
                  planes, so the scan (C or I) reads 21 of the residues' 28
                  bits (the cut a faster scan would be tempted by); breaks
                  the configuration's exact answers
    stale_write   every other row's write is acknowledged and its bytes
                  dropped: the index keeps its state (zeros) for those
                  rows, while the bucket counts them written, so the fill
                  leaves the layout it leaves without the fault
    half_batch    each dispatch computes the first half of its queries
                  only and answers the rest with copies of those answers
    altered       one bit of each batch's first answer flipped where the
                  engine produces it: the top bit of the first 10-bit
                  field after instance 0's first row, which moves the
                  decoded byte by p / 2
"""

from __future__ import annotations

import math


class Fault:
    def before_fill(self, srv) -> None:
        pass

    def after_fill(self, srv) -> None:
        pass


class LowLimb(Fault):
    def after_fill(self, srv) -> None:
        db = srv.engine.db
        if srv.meta()["index_layout"] == "compact":
            db = db.planes
        db[:, :, 0].zero_()


class StaleWrite(Fault):
    def before_fill(self, srv) -> None:
        inner = srv.update_item_raw

        def update_item_raw(db_idx, data):
            inner(db_idx, data if db_idx % 2 == 0 else bytes(len(data)))
        srv.update_item_raw = update_item_raw


class HalfBatch(Fault):
    def after_fill(self, srv) -> None:
        inner = srv.engine.dispatch_queries_batched

        def dispatch(requests):
            half = requests[:(len(requests) + 1) // 2]
            fetch = inner(half)

            def fetch_all():
                got = fetch()
                return [got[i % len(got)] for i in range(len(requests))]
            return fetch_all
        srv.engine.dispatch_queries_batched = dispatch


class Altered(Fault):
    def after_fill(self, srv) -> None:
        p = srv.params
        q1_bits = math.ceil(math.log2(4 * p.pt_modulus))
        bit = p.n * p.poly_len * p.q2_bits + q1_bits - 1
        inner = srv.engine.dispatch_queries_batched

        def dispatch(requests):
            fetch = inner(requests)

            def fetch_altered():
                got = fetch()
                first = bytearray(got[0])
                first[bit // 8] ^= 1 << (bit % 8)
                return [bytes(first)] + got[1:]
            return fetch_altered
        srv.engine.dispatch_queries_batched = dispatch


FAULTS = {"low_limb": LowLimb, "stale_write": StaleWrite,
          "half_batch": HalfBatch, "altered": Altered}
