"""Cross-implementation debugging aids for DoublePIR.

Mirrors the reference's divergence-hunting toolkit:

- XOR-checksum matrix fingerprints (reference matrix/matrix.rs:176-196,
  util/checksum.rs): the SAME named checksums print from the Python scheme
  (scheme.py), the device server (server_torch.py) and the TS client
  (js/src/doublepir/debug.ts), so a state divergence between the two
  client codebases and the server localizes to the first differing name.
  Gated by COMPUTE_FULL_CHECKSUMS (env SDK_TPU_CHECKSUMS=1 — the runtime
  analog of the reference's compile-time const, matrix.rs:19-24): when off,
  checksum() returns 0 without reading the data, exactly like the
  reference, because full passes over multi-GB matrices have significant
  runtime cost.

- Leveled logging with a hard kill switch (reference util/log.rs:10-14):
  `set_level` / ERROR..DEBUG, plus HARD_QUIET (env SDK_TPU_LOG_QUIET=1,
  default ON like the reference) that silences everything regardless of
  level — logging measurably slows the kernels' host loop, so benches run
  fully quiet.

Checksum lines print to stderr as ``{msg}: {checksum}`` at DEBUG level —
the byte-identical format the TS side emits.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ERROR, WARN, INFO, DEBUG = 0, 1, 2, 3

# reference defaults: HARD_QUIET = true, COMPUTE_FULL_CHECKSUMS = false
HARD_QUIET = os.environ.get("SDK_TPU_LOG_QUIET", "1") != "0"
COMPUTE_FULL_CHECKSUMS = bool(os.environ.get("SDK_TPU_CHECKSUMS"))

_LEVEL = int(os.environ.get("SDK_TPU_LOG_LEVEL", ERROR))


def set_level(level: int) -> None:
    global _LEVEL
    _LEVEL = level


def get_level() -> int:
    return _LEVEL


def _log(level: int, msg: str) -> None:
    if HARD_QUIET or _LEVEL < level:
        return
    print(msg, file=sys.stderr, flush=True)


def info(msg: str) -> None:
    _log(INFO, msg)


def debug(msg: str) -> None:
    _log(DEBUG, msg)


def checksum_u32(arr) -> int:
    """XOR of all u32 values (reference util/checksum.rs:11-17); arr may be
    a numpy or device array of any shape."""
    a = np.asarray(arr)
    assert a.dtype == np.uint32, a.dtype
    return int(np.bitwise_xor.reduce(a, axis=None))


def checksum_u8(data: bytes) -> int:
    """XOR of all bytes (reference util/checksum.rs:2-8)."""
    a = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(np.bitwise_xor.reduce(a)) if a.size else 0


def matrix_checksum(arr) -> int:
    """Gated full fingerprint (reference Matrix::checksum): 0 when
    COMPUTE_FULL_CHECKSUMS is off, the XOR of every u32 otherwise."""
    if not COMPUTE_FULL_CHECKSUMS:
        return 0
    return checksum_u32(arr)


def print_checksum(msg: str, arr) -> None:
    """Reference Matrix::print_checksum — ``{msg}: {checksum}`` at DEBUG."""
    if HARD_QUIET or _LEVEL < DEBUG:
        return  # skip the (expensive) data pass entirely
    _log(DEBUG, f"{msg}: {matrix_checksum(arr)}")
