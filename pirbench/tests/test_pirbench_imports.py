"""What a run loads: no module whose top-level name is jax, jaxlib, flax or
sdk_tpu (compared whole: sdk_tpu_torch is the program); the reference and
the load processes' modules load nothing of sdk_tpu_torch or torch."""

from __future__ import annotations

import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "sdk_tpu"}


def loaded(modules: list[str]) -> set[str]:
    code = ("import importlib, sys; sys.path.insert(0, '.'); "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(res.stdout.split())


def modules_under(rel: str) -> list[str]:
    out = []
    for p in sorted(glob.glob(os.path.join(ROOT, rel, "**", "*.py"),
                              recursive=True)):
        mod = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        if ".tests." not in mod:
            out.append(mod.removesuffix(".__init__"))
    return out


def test_run_loads_neither_jax_nor_the_jax_package():
    mods = modules_under("pirbench") + ["torch.profiler"]
    held = loaded(mods)
    assert "sdk_tpu_torch" in held
    assert not held & FORBIDDEN


def test_reference_and_load_processes_load_nothing_of_the_program():
    held = loaded(modules_under("pirbench/reference")
                  + ["pirbench.harness.load", "pirbench.harness.traffic"])
    assert not held & (FORBIDDEN | {"sdk_tpu_torch", "torch"})
