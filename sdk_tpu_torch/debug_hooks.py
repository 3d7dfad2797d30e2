"""State of the CLIENT_TEST noise-localization hook (reference
lib/spiral-rs/src/client.rs:15, lib/spiral-rs/src/server.rs:713-729).

Copied from sdk_tpu.debug_hooks: only the hook's state. A test plants the
client's regev secret key and the expected plaintext with
``set_client_test``; the port's engine does not decrypt mid-pipeline yet
and refuses to serve while the hook is set (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# (sk_reg raw (1, 1, poly_len) u64, target raw mod-p (1, 1, poly_len) u64)
_CLIENT_TEST: tuple[np.ndarray, np.ndarray] | None = None


def set_client_test(sk_reg: np.ndarray, target: np.ndarray) -> None:
    global _CLIENT_TEST
    sk = np.asarray(sk_reg, dtype=U64).reshape(1, 1, -1)
    tg = np.asarray(target, dtype=U64).reshape(1, 1, -1)
    _CLIENT_TEST = (sk, tg)


def clear_client_test() -> None:
    global _CLIENT_TEST
    _CLIENT_TEST = None


def client_test_active() -> bool:
    return _CLIENT_TEST is not None
