"""A configuration, a traffic mix and a per-layer metric added as new files
(with their entries in BENCHMARK.json) are found by name and run; no file
of pirbench/ that was there changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from pirbench.harness.cells import load_cell, load_reader
from pirbench.harness.layers import LayerView
from pirbench.run import run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
READER = '''
def read(view):
    return float(len(view.spans)) if view.spans else None
'''


def digests(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "pirbench"), tmp_path / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = digests(tmp_path / "pirbench")
    pb = tmp_path / "pirbench"

    with open(pb / "configs" / "spiral-1gib-window25.json") as f:
        cfg = json.load(f)
    cfg.update(name="spiral-1gib-window5", batch_window_ms=5)
    (pb / "configs" / "spiral-1gib-window5.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "pairs.json").write_text(json.dumps({
        "loop": "closed", "clients": 8, "processes": 2,
        "keys_per_request": 2, "think_ms": 1, "rows": "uniform",
        "pool_per_client": 2, "ramp_s": 1}))
    (pb / "metrics" / "dispatches_counted.py").write_text(READER)
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "spiral-1gib-window5", "source": "a test",
        "file": "pirbench/configs/spiral-1gib-window5.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "spiral-1gib-window5.pairs", "config": "spiral-1gib-window5",
        "traffic": "pairs", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "reads_per_s.pairs", "unit": "reads/s", "better": "higher",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["spiral-1gib-window5.pairs"]})
    bench["per_layer"].append({
        "name": "dispatches_counted", "unit": "dispatches",
        "better": "higher", "source": "program_span", "layer": "engine",
        "moves": "reads_per_s.pairs",
        "workloads": ["spiral-1gib-window5.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(pb)
    assert {k: after[k] for k in before} == before

    cell = load_cell(str(tmp_path), "spiral-1gib-window5.pairs")
    assert cell.config["batch_window_ms"] == 5
    assert cell.traffic.name == "pairs" and cell.traffic.clients == 8
    assert "dispatches_counted" in [m["name"] for m in cell.per_layer]
    old = load_cell(str(tmp_path), "spiral-1gib-window25.batched")
    assert "dispatches_counted" not in [m["name"] for m in old.per_layer]
    read = load_reader(str(tmp_path), "dispatches_counted")
    assert read(LayerView(None, [[0, 1, 2, 3, 4]] * 3, None, {}, "")) == 3.0
    assert read(LayerView(None, [], None, {}, "")) is None
    # a quantity split by cell falls back to the quantity's reader
    assert load_reader(str(tmp_path), "dispatches_counted.pairs") is not None

    r = run_cell("spiral-1gib-window5.pairs", 3000000029, 5, False,
                 root=str(tmp_path), cpu_tiny=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"reads_per_s.pairs", "setup_s"}
