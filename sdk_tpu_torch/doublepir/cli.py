"""DoublePIR command-line tools (reference lib/doublepir/src/bin/
{preprocess,e2e,client}.rs).

  preprocess <num_entries> <bits_per_entry> <data.bin> <out_base>
      Build + save the preprocessed DB/hint/state file set.
  e2e [num_entries_log2]
      Chunked batch e2e over DB slices with response re-aggregation — the
      DB-sharding / partial-sum-reduce demo (bin/e2e.rs:60-106).
  client <base_url> <key> [--log2m N]
      Checklist lookup against a live service (password -> bloom indices
      -> batched private reads), reference bin/client.rs:28-58.
"""

from __future__ import annotations

import sys

import numpy as np


def cmd_preprocess(argv: list[str]) -> int:
    from .server import DoublePirServer

    num_entries, bits = int(argv[0]), int(argv[1])
    data_fname, out_base = argv[2], argv[3]
    with open(data_fname, "rb") as f:
        raw = f.read()
    # bit-file semantics (database.rs load_data_fast): LSB-first bits
    bits_arr = np.unpackbits(np.frombuffer(raw, dtype=np.uint8),
                             bitorder="little")[:num_entries]
    srv = DoublePirServer(num_entries, bits)
    srv.load_data(bits_arr.tolist())
    srv.save_to_files(out_base)
    print(f"saved preprocessed DB to {out_base}.*")
    return 0


def cmd_e2e(argv: list[str]) -> int:
    from . import scheme
    from .database import Db
    from .params import LOGQ, SEC_PARAM, pick_params

    log2n = int(argv[0]) if argv else 16
    num_entries = 1 << log2n
    rng = np.random.default_rng(0)
    params = pick_params(num_entries, 1, SEC_PARAM, LOGQ, lower_bound_m=1)
    print(f"params: {params.to_string()}")
    vals = rng.integers(0, 2, num_entries, dtype=np.uint64)
    i1, i2 = 1234 % num_entries, (num_entries // 2 + 77) % num_entries
    vals[i1] = 1
    vals[i2] = 1
    db = Db.from_entries(num_entries, 1, params, vals.tolist())
    shared = scheme.init(db.info, params)
    server_state, hint = scheme.setup(db, shared, params)
    cs1, q1 = scheme.query(i1, shared, params, db.info, rng)
    cs2, q2 = scheme.query(i2, shared, params, db.info, rng)
    queries = [q1, q2]

    # chunked answers with partial-sum re-aggregation
    num_chunks = 2
    batch_sz = db.data.shape[0] // num_chunks
    chunks = [db.data[:batch_sz], db.data[batch_sz:]]
    full = None
    for chunk_idx, slc in enumerate(chunks):
        resp = scheme.answer(db, queries, server_state, params,
                             raw_data=slc, chunk_idx=chunk_idx)
        if full is None:
            full = resp
        else:
            for ridx in range(len(resp)):
                if ridx % 2 == 0:
                    full[ridx] = full[ridx] + resp[ridx]
    r1 = scheme.recover(i1, 0, hint, q1, full, shared, cs1, params, db.info)
    r2 = scheme.recover(i2, 1, hint, q2, full, shared, cs2, params, db.info)
    ok = (r1 == int(vals[i1]) and r2 == int(vals[i2]))
    print(f"recovered {r1}, {r2}; expected {vals[i1]}, {vals[i2]} -> "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_client(argv: list[str]) -> int:
    from ..clients.api import API
    from ..clients.bucket import Bucket

    base_url, key = argv[0], argv[1]
    bucket = Bucket(API("", base_url))
    present = bucket.check_inclusion(key)
    print(f"'{key}': {'PRESENT' if present else 'not present'}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "preprocess":
        return cmd_preprocess(rest)
    if cmd == "e2e":
        return cmd_e2e(rest)
    if cmd == "client":
        return cmd_client(rest)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())


def cli():
    sys.exit(main())
