"""Build the port's CUDA kernels and bind them with ctypes.

The sources under ``sdk_tpu_torch/csrc/*.cu`` have a plain C interface.
They are compiled at first use with ``nvcc`` for Hopper (``sm_90a``) into
one shared library under ``build/sdk_tpu_torch/`` at the repository root,
named by a hash of the sources and flags so an edit rebuilds, and loaded
with ``ctypes``. A missing ``nvcc`` or a failed build raises.

Every C entry point enqueues its kernel on the stream it is given and
returns the ``cudaGetLastError()`` of the launch; :func:`launch` raises on a
non-zero code and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sdk_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Kernel launches by kernel name, counted where each wrapper launches.
LAUNCHES: dict[str, int] = {"ntt_forward": 0, "ntt_inverse": 0,
                            "matmul_mod": 0, "scan": 0, "encode": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_ULL = ctypes.c_ulonglong
_SIGNATURES = {
    "sdk_ntt": (_P, _P, _P, _LL, _I, _U, _U, _I, _P),
    "sdk_matmul_mod": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _U, _U, _P),
    "sdk_scan": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _P),
    "sdk_encode": (_P, _P, _LL, _I, _I, _I, _U, _U, _U, _U, _U, _U, _U, _ULL,
                   _U, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, not under $CUDA_HOME/bin): the "
            "sdk_tpu_torch CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash) and
    return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libsdk_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.sdk_error_string.argtypes = (ctypes.c_int,)
            so.sdk_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` with ``device`` current, raise on a
    launch error, count the launch."""
    so = lib()
    with torch.cuda.device(device):
        rc = getattr(so, entry)(*args)
    if rc != 0:
        msg = so.sdk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got "
                             f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
