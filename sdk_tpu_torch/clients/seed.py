"""32-byte base64 client seeds; every client secret derives from one
(reference python/blyss/seed.py, js/client/seed.ts)."""

from __future__ import annotations

import base64
import os

SEED_BYTES = 32
SEED_STR_LEN = 44


def string_from_seed(seed: bytes) -> str:
    assert len(seed) == SEED_BYTES
    s = base64.standard_b64encode(seed).decode()
    assert len(s) == SEED_STR_LEN
    return s


def seed_from_string(seed_str: str) -> bytes:
    assert len(seed_str) == SEED_STR_LEN
    seed = base64.standard_b64decode(seed_str)
    assert len(seed) == SEED_BYTES
    return seed


def get_random_seed() -> str:
    return string_from_seed(os.urandom(SEED_BYTES))
