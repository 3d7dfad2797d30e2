"""The control and the faults that a cell can have, planted under the timed
path on the port's plain CPU path (--cpu-tiny): each run drives the rest of
a run and must come out not correct. One chip only: no exchange between
chips to leave out. A dispatch of one query has no half to leave out: a cell
with no window and one key a request skips that fault."""

from __future__ import annotations

import json
import os

import pytest

from pirbench.harness.cells import load_cell
from pirbench.harness.faults import FAULTS
from pirbench.run import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


def one_query_dispatches(cell: str) -> bool:
    c = load_cell(ROOT, cell)
    return (c.traffic.keys_per_request == 1
            and float(c.config["batch_window_ms"]) <= 0)


CASES = [(cell, fault) for cell in CELLS for fault in sorted(FAULTS)
         if not (fault == "half_batch" and one_query_dispatches(cell))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault):
    r = run_cell(cell, 3000000023, 5, False, cpu_tiny=True,
                 fault=FAULTS[fault]())
    assert r["correct"] is False
    assert r["checks"]["requests_not_right"]["value"] == r["failed"] > 0
