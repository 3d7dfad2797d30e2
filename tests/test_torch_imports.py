"""Import hygiene and dispatch of the port: neither jax nor the JAX package
sdk_tpu anywhere in sdk_tpu_torch or chip_smoke.py, CPU tensors take the
plain versions without building anything, the entry points ask for the card
by default, and chip_smoke.py refuses to report without a card."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sdk_tpu_torch
from sdk_tpu_torch import _build
from sdk_tpu_torch.params import get_fast_expansion_testing_params

ROOT = Path(__file__).resolve().parent.parent
PARAMS = get_fast_expansion_testing_params()


def port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        sdk_tpu_torch.__path__, "sdk_tpu_torch."))


def test_every_module_imports_without_jax():
    """Every port module, chip_smoke.py and tools/profile_trace_torch.py
    import with a meta-path finder that refuses jax, jaxlib, sdk_tpu and
    every sdk_tpu.* module (not sdk_tpu_torch)."""
    mods = port_modules()
    assert {"sdk_tpu_torch.server.kv_server",
            "sdk_tpu_torch.server.doublepir_server",
            "sdk_tpu_torch.server.http",
            "sdk_tpu_torch.clients.bloom",
            "sdk_tpu_torch.clients.serializer",
            "sdk_tpu_torch.clients.seed",
            "sdk_tpu_torch.clients.api",
            "sdk_tpu_torch.clients.bucket",
            "sdk_tpu_torch.clients.bucket_service",
            "sdk_tpu_torch.clients.proof",
            "sdk_tpu_torch.clients.async_bucket",
            "sdk_tpu_torch.doublepir.cli",
            "sdk_tpu_torch.kv.ingest",
            "sdk_tpu_torch.doublepir.kernels",
            "sdk_tpu_torch.doublepir.server_torch",
            "sdk_tpu_torch.doublepir.scheme",
            "sdk_tpu_torch.doublepir.client",
            "sdk_tpu_torch.ops.shard",
            "sdk_tpu_torch.selfcheck",
            "sdk_tpu_torch.server.dcn"} <= set(mods)
    code = ("import importlib, sys\n"
            "class Refuse:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdk_tpu'):\n"
            "            raise ImportError(f'refused: {name}')\n"
            "sys.meta_path.insert(0, Refuse())\n"
            "sys.path.insert(0, 'tools')\n"
            f"for m in {mods + ['chip_smoke', 'profile_trace_torch']!r}: "
            "importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sdk_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def port_sources() -> list[Path]:
    return list((ROOT / "sdk_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "profile_trace_torch.py"]


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    assert not [str(f) for f in port_sources() if pat.search(f.read_text())]


def test_sources_never_import_sdk_tpu():
    """No import of the JAX package, at any depth of a function."""
    pat = re.compile(r"^\s*(from|import)\s+sdk_tpu(\.|\s|$)", re.M)
    assert not [str(f) for f in port_sources() if pat.search(f.read_text())]


@pytest.mark.parametrize("entry", ["bucket", "engine"])
def test_entry_points_default_to_the_card(entry):
    """Without a device the entry points ask for CUDA: here, where there is
    none, construction raises instead of falling back to the CPU."""
    from sdk_tpu_torch.ops.server import SpiralServerTorch
    from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cls = SpiralKvServerTorch if entry == "bucket" else SpiralServerTorch
    with pytest.raises((RuntimeError, AssertionError)):
        cls(PARAMS)


def test_cpu_tensors_take_plain_path_without_build(monkeypatch):
    from sdk_tpu_torch.kv import ingest
    from sdk_tpu_torch.ops import ntt, spiral
    from sdk_tpu_torch.ops.encode import ResponseEncodePlan

    def no_build():
        raise AssertionError("a CPU tensor must not build the kernels")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(_build.LAUNCHES)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 1 << 19, (2, 2, 2048)).astype(np.int32))
    ntt.ntt_inverse(PARAMS, ntt.ntt_forward(PARAMS, x))
    spiral.matmul_mod(PARAMS, x[:, None].expand(2, 2, 2, 2048).contiguous(),
                      x[None, :, None].expand(4, 2, 1, 2, 2048).contiguous())
    db = torch.zeros(spiral.db_shape(PARAMS), dtype=torch.int8)
    spiral.firstdim_multiply(PARAMS, db, torch.zeros(
        (2, 2048, 1 << PARAMS.db_dim_1, 2), dtype=torch.int32))
    ResponseEncodePlan(PARAMS, "cpu").encode(torch.zeros(
        (1, 3, 2, 2048), dtype=torch.int64))
    keys = torch.zeros((PARAMS.db_dim_2, 2, 2 * PARAMS.t_gsw, 2, 2048),
                       dtype=torch.int32)
    spiral.fold_ciphertexts(PARAMS, torch.ones(
        (1 << PARAMS.db_dim_2, 2, 1, 2048), dtype=torch.int64), keys, keys)
    spiral.pack(PARAMS, torch.ones((4, 2, 1, 2048), dtype=torch.int64),
                [torch.zeros((3, PARAMS.t_conv, 2, 2048), dtype=torch.int32)]
                * 2)
    ingest.ingest_into(PARAMS, db, [1], [2], torch.ones(
        (1, 4, 2048), dtype=torch.uint8))
    assert _build.LAUNCHES == before
    assert _build._lib is None


def test_other_devices_raise():
    from sdk_tpu_torch.ops import ntt

    with pytest.raises(ValueError):
        ntt.ntt_forward(PARAMS, torch.zeros((1, 2, 2048), dtype=torch.int32,
                                            device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
