"""Finding a cell's pieces by name: BENCHMARK.json names the cell's
configuration and traffic, and its metrics; each piece is a file of its
own under pirbench/:

    configs/<config>.json      (the ``file`` BENCHMARK.json gives it)
    traffic/<traffic>.json
    metrics/<metric>.py        a per-layer metric's reader: read(view);
                               <quantity>.<part> falls back to
                               metrics/<quantity>.py

A later cell, mix or per-layer metric is a new file and new entries in
BENCHMARK.json; no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

from .traffic import Traffic, load_traffic


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: Traffic
    end_to_end: list[dict]      # BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[w["config"]]["file"])) as f:
        config = json.load(f)
    traffic = load_traffic(os.path.join(root, "pirbench", "traffic",
                                        f"{w['traffic']}.json"), w["traffic"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_reader(root: str, metric: str):
    """The ``read`` function of pirbench/metrics/<metric>.py. A quantity
    split by the end-to-end metric it moves, ``<quantity>.<part>``, is read
    by pirbench/metrics/<quantity>.py unless the part has a reader of its
    own."""
    path = os.path.join(root, "pirbench", "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "pirbench", "metrics",
                            f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"pirbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
