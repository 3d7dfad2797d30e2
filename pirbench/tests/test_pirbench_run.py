"""Every cell of BENCHMARK.json, end to end on the port's plain CPU path at
the fast testing parameters (--cpu-tiny): the result line's keys, correct,
and the cell's end-to-end metrics; without a card the run refuses."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(args: list[str], cwd: str = ROOT, timeout: float = 300.0,
        prelude: str = ""):
    code = (f"import sys; sys.path.insert(0, {os.path.join(cwd, 'pirbench')!r}); "
            f"{prelude}import runpy; sys.argv = ['pirbench/run.py'] + "
            f"{args!r}; runpy.run_path('pirbench/run.py', run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def last_json(stdout: str):
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return None


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end_on_the_cpu(cell):
    res = run(["--workload", cell, "--seed", "3000000017", "--seconds", "6",
               "--trace", "0", "--cpu-tiny"])
    assert res.returncode == 0, res.stderr[-3000:]
    out = last_json(res.stdout)
    assert list(out) == KEYS
    assert out["correct"] is True, res.stderr[-3000:]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert res.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    """This machine has no CUDA card: the run exits non-zero, prints no
    result and never falls back to the CPU."""
    res = run(["--workload", CELLS[0], "--seed", "5", "--seconds", "1",
               "--trace", "0"])
    assert res.returncode != 0
    assert last_json(res.stdout) is None
    assert "torch.cuda.is_available() is false" in res.stderr


def test_jax_in_the_process_no_result():
    """A run whose process holds jax once its window has closed exits
    non-zero with no result and names what it found."""
    res = run(["--workload", CELLS[-1], "--seed", "7", "--seconds", "2",
               "--trace", "0", "--cpu-tiny"],
              prelude="import types; sys.modules['jax'] = "
                      "types.ModuleType('jax'); ")
    assert res.returncode != 0
    assert last_json(res.stdout) is None
    assert "['jax']" in res.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and pirbench/, the run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pirbench"), tmp_path / "pirbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0", "--cpu-tiny"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert last_json(res.stdout) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """The cell as the benchmark runs it, on the card, for a short window."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "pirbench/run.py", "--workload", cell, "--seed",
         "3000000019", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    out = last_json(res.stdout)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
