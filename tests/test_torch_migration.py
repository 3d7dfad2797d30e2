"""State S3 of the bucket lifecycle (see tests/test_torch_lifecycle.py): a
compact bucket that crosses the migration limit moves to the dense index
on its next flush, with responses byte-identical to the JAX package's numpy
oracle over the same rows; and a migration the device budget refuses leaves
the bucket compact and serving."""

import numpy as np

from sdk_tpu_torch.ops.spiral import CompactDb

from test_torch_lifecycle import Pair, check_rows, rand_rows


def test_s3_migration_to_dense_matches_jax():
    pair = Pair()
    rng = np.random.default_rng(33)
    first = rand_rows(pair.pt, rng, range(0, 80, 4))          # 20 items
    pair.write_rows(first)
    pair.port.flush()
    assert pair.layout() == ("compact", False)
    # 40 items > 0.125 * 256: the next flush migrates, then writes
    more = rand_rows(pair.pt, rng, range(1, 200, 10))
    pair.write_rows(more)
    rows = {**first, **more}
    targets = [41, 8, 191]
    blobs = [pair.blob(i % 2, t, 20 + i) for i, t in enumerate(targets)]
    single = pair.read(blobs[0])
    assert pair.layout() == ("dense", False)
    assert not pair.port._updates.slots.slot_of
    resps = pair.batch(blobs)
    assert resps[0] == single
    check_rows(pair, blobs, resps, [0, 1, 0], rows, targets)


def test_refused_migration_keeps_serving_compact():
    """kv_server.py:232-246: a budget too small for the dense index refuses
    the migration with a warning and the bucket keeps serving compact."""
    pair = Pair()
    pair.port.hbm_budget_bytes = 1 << 20
    pair.port.dense_migrate_fill = 0.0
    rows = rand_rows(pair.pt, np.random.default_rng(34), [3, 77])
    pair.write_rows(rows)
    blob = pair.blob(0, 77, 30)
    resp = pair.read(blob)
    assert pair.port._migration_refused
    assert isinstance(pair.port.engine.db, CompactDb)
    check_rows(pair, [blob], [resp], [0], rows, [77])
