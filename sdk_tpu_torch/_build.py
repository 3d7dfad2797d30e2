"""Build the port's CUDA kernels and bind them with ctypes.

Each source ``sdk_tpu_torch/csrc/<name>.cu`` has a plain C interface. At
first use every source is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library of its own under ``build/sdk_tpu_torch/`` at the
repository root; the ``nvcc`` processes run side by side. Each library is
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edit rebuilds only what it touches, and is loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises.

Every C entry point enqueues its kernel on the stream it is given and
returns the ``cudaGetLastError()`` of the launch; :func:`launch` raises on a
non-zero code and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "sdk_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches by kernel name, counted where each wrapper launches.
LAUNCHES: dict[str, int] = {"ntt_forward": 0, "ntt_inverse": 0,
                            "matmul_mod": 0, "scan": 0, "scan_resident": 0,
                            "encode": 0,
                            "scan_compact": 0, "expand_round": 0,
                            "dp_dot_i8": 0, "dp_matmul_u32": 0,
                            "fold_round": 0, "pack": 0, "ingest": 0,
                            "compact_to_dense": 0, "psum_mod": 0,
                            "expansion": 0, "regev_to_gsw": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_ULL = ctypes.c_ulonglong
# C entry point -> (source stem, argument types)
_SIGNATURES = {
    "sdk_ntt": ("ntt", (_P, _P, _P, _LL, _I, _U, _U, _I, _P)),
    "sdk_error_string": ("ntt", (_I,)),
    "sdk_matmul_mod": ("matmul_mod",
                       (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _U, _U, _P)),
    "sdk_scan": ("scan", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _U, _U, _P)),
    "sdk_scan_resident": ("scan", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _U, _U, _P, _P)),
    "sdk_scan_compact": ("scan_compact", (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                          _U, _U, _P, _P)),
    "sdk_encode": ("encode", (_P, _P, _LL, _I, _I, _I, _U, _U, _U, _U, _U, _U,
                              _U, _ULL, _U, _P)),
    "sdk_expand_round": ("expand_round", (_P, _P, _P, _P, _LL, _I, _I, _I,
                                          _ULL, _U, _U, _ULL, _P)),
    "sdk_dp_dot_i8_select": ("dp_dot_i8", (_P, _LL, _P, _P, _P, _LL, _I, _LL,
                                           _I, _P)),
    "sdk_dp_dot_i8_tiled": ("dp_dot_i8", (_P, _P, _LL, _P, _LL, _I, _P, _P,
                                          _LL, _I, _P)),
    "sdk_dp_dot_i8_narrow": ("dp_dot_i8", (_P, _P, _LL, _P, _I, _P, _P, _LL,
                                           _I, _P)),
    "sdk_dp_dot_i8_narrow_occupancy": ("dp_dot_i8", (_I,)),
    "sdk_dp_mma_wrap_probe": ("dp_dot_i8", (_P, _I, _P)),
    "sdk_dp_matmul_u32": ("dp_matmul_u32", (_P, _LL, _P, _P, _LL, _I, _I, _I,
                                            _P)),
    "sdk_dp_answer_u32": ("dp_matmul_u32", (_P, _LL, _I, _P, _I, _P, _P, _I,
                                            _P, _I, _P)),
    "sdk_dp_answer_blocks": ("dp_matmul_u32", ()),
    "sdk_fold_round": ("fold_round", (_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                      _I, _I, _I, _U, _U, _ULL, _I, _P)),
    "sdk_fold_round_occupancy": ("fold_round", ()),
    "sdk_pack": ("pack", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _U, _U, _ULL, _LL, _ULL, _U, _U, _U, _U, _U, _P)),
    "sdk_pack_occupancy": ("pack", (_I, _I, _I)),
    "sdk_ingest": ("ingest", (_P, _P, _P, _P, _P, _I, _P, _P, _P, _LL, _I, _I,
                              _I, _I, _I, _LL, _LL, _I, _U, _U, _P)),
    "sdk_compact_to_dense": ("compact_to_dense", (_P, _P, _P, _P, _LL, _I, _I,
                                                  _I, _I, _I, _I, _I, _I, _P)),
    "sdk_psum_mod": ("psum_mod", (_P, _I, _LL, _LL, _U, _U, _ULL, _U, _U, _ULL,
                                  _I, _P, _P)),
    "sdk_expansion": ("expansion", (_P, _P, _P, _LL, _LL, _I, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _ULL, _U, _U,
                                    _ULL, _I, _P)),
    "sdk_expansion_occupancy": ("expansion", ()),
    "sdk_regev_to_gsw": ("regev_to_gsw", (_P, _P, _LL, _I, _P, _P, _P, _P,
                                          _P, _I, _I, _I, _I, _U, _U, _ULL,
                                          _I, _P)),
    "sdk_regev_to_gsw_occupancy": ("regev_to_gsw", ()),
}

_lock = threading.Lock()
_lib: dict | None = None


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


def _compile(nvcc: str, src: Path, out: Path) -> None:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    _ptxas_log(out).write_text(res.stdout + res.stderr)
    os.replace(tmp, out)


def build() -> dict[str, Path]:
    """Compile every csrc/*.cu into its shared library (once per hash), all
    sources at once, and return {source stem: library path}."""
    sources = sorted(CSRC.glob("*.cu"))
    common = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        common.update(hdr.name.encode())
        common.update(hdr.read_bytes())
    libs, todo = {}, []
    for src in sources:
        h = common.copy()
        h.update(src.read_bytes())
        out = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
        libs[src.stem] = out
        if not out.exists():
            todo.append((src, out))
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            futures = [pool.submit(_compile, nvcc, s, o) for s, o in todo]
        errors = [str(f.exception()) for f in futures if f.exception()]
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def _ptxas_log(out: Path) -> Path:
    return out.with_suffix(".ptxas.txt")


def ptxas_usage(stem: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in csrc/<stem>.cu, by
    mangled name, from the ``-Xptxas -v`` report of its build; empty when
    the build left no report."""
    path = _ptxas_log(build()[stem])
    if not path.exists():
        return {}
    usage, name = {}, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def lib() -> dict:
    """The C entry points by name, built and loaded on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            sos = {stem: ctypes.CDLL(str(path))
                   for stem, path in build().items()}
            fns = {}
            for name, (stem, argtypes) in _SIGNATURES.items():
                fn = getattr(sos[stem], name)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p if name == "sdk_error_string"
                              else ctypes.c_int)
                fns[name] = fn
            _lib = fns
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` with ``device`` current (made current
    only if it is not), raise on a launch error, count the launch."""
    fns = lib()
    fn = fns[entry]
    # ctypes passes surplus arguments unconverted, shifting the rest
    if len(args) != len(fn.argtypes):
        raise TypeError(f"{entry}: {len(args)} arguments, "
                        f"{len(fn.argtypes)} declared")
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(device):
            rc = fn(*args)
    if rc != 0:
        msg = fns["sdk_error_string"](rc).decode()
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
