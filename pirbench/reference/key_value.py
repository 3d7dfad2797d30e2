# Frozen copy of row_from_key from sdk_tpu_torch/kv/key_value.py at commit
# 19a17d4, part of the benchmark's yardstick: it places a configuration's
# keys on their rows. Later changes to the program do not change it.
"""Key -> PIR row: the top ceil(log2 num_items) bits of SHA-256(key),
big-endian (reference key_value.rs:25-40)."""

from __future__ import annotations

import hashlib
import math


def row_from_key(num_items: int, key: str) -> int:
    buckets_log2 = math.ceil(math.log2(num_items))
    h = hashlib.sha256(key.encode()).digest()
    idx = 0
    for i in range(buckets_log2):
        if h[i // 8] & (1 << (7 - (i % 8))):
            idx += 1 << (buckets_log2 - i - 1)
    return idx
