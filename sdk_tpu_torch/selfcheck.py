"""Self-contained sharded-serving correctness checks (ports
sdk_tpu/selfcheck.py).

``sharded_protocol_check`` runs the full Spiral protocol (keygen -> query ->
sharded expand/scan/sum/fold/pack/encode -> client decode) over a mesh and
asserts that the response bytes equal unsharded serving on the mesh's home
device and that the client decodes the planted row.
``sharded_doublepir_check`` does the same for the row-sharded checklist
(hint and every answer word, then the planted bits through the client).
Both hold kernel M (ops/shard.psum_mod) on whatever devices the mesh names:
logical CPU shards in the tests, logical shards of one card in
chip_smoke.py, several cards where there are.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.shard import Mesh


def sharded_protocol_check(mesh: Mesh) -> None:
    """Sharded-vs-unsharded bit-exactness of a whole response at the fast
    test params (dim0 64, 4 trials), and the client's decode of the planted
    row. Raises AssertionError on any divergence."""
    from .client import Client
    from .kv.ingest import DbUpdateBuffer
    from .ops.server import SpiralServerTorch
    from .ops.spiral import db_shape
    from .params import get_fast_expansion_testing_params
    from .rng import ChaCha20Rng

    params = get_fast_expansion_testing_params()
    home = mesh.home
    rng = np.random.default_rng(41)
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    target = 41 % params.num_items()
    rows = {i: rng.integers(0, 256, row_len - 3, dtype=np.uint8).tobytes()
            for i in (target, 0, 7, params.num_items() - 1)}
    buf = DbUpdateBuffer(params, home)
    for i, data in rows.items():
        buf.upsert_raw(i, data)
    dense = buf.flush(torch.zeros(db_shape(params), dtype=torch.int8,
                                  device=home))

    client = Client(params)
    pp = client.generate_keys_from_seed(
        b"\x31" * 32, noise_rng=ChaCha20Rng(b"\x32" * 32),
        pp_seed=b"\x33" * 32)
    query = client.generate_query(
        target, noise_rng=ChaCha20Rng(b"\x34" * 32), query_seed=b"\x35" * 32)

    single = SpiralServerTorch(params, home)
    single.set_db(dense)
    sharded = SpiralServerTorch(params, mesh=mesh)
    sharded.set_db(dense)
    want = single.process_query(pp, query)
    got = sharded.process_query(pp, query)
    assert got == want, "sharded response bytes differ from unsharded serving"
    assert client.decode_response(got)[:len(rows[target])] == rows[target], (
        "client decode mismatch after sharded serving")


def sharded_doublepir_check(mesh: Mesh) -> None:
    """The row-sharded checklist (ChecklistServerTorch(mesh=)) against the
    unsharded one on the home device: the hint and the whole answer State
    word for word, then the planted bits recovered through the scheme.
    l = 13 over uneven shards exercises the pad-row masking (setup) and the
    zero-contribution pad rows (answer)."""
    from .doublepir import scheme
    from .doublepir.params import Params
    from .doublepir.server_torch import ChecklistServerTorch

    params = Params(n=64, sigma=6.4, l=13, m=17, logq=32, p=464)
    num_entries = params.l * params.m * 8 - 5
    rng = np.random.default_rng(3)
    bit_bytes = rng.integers(0, 256, (num_entries + 7) // 8,
                             dtype=np.uint16).astype(np.uint8)
    a_1 = rng.integers(0, 1 << 32, (params.m, params.n),
                       dtype=np.uint64).astype(np.uint32)
    a_2 = rng.integers(0, 1 << 32, (params.l, params.n),
                       dtype=np.uint64).astype(np.uint32)
    shared = [a_1, a_2]

    single = ChecklistServerTorch(num_entries, params, bit_bytes,
                                  device=mesh.home)
    hint_single = single.setup(shared)
    sharded = ChecklistServerTorch(num_entries, params, bit_bytes, mesh=mesh)
    hint_sharded = sharded.setup(shared)
    np.testing.assert_array_equal(hint_sharded[0], hint_single[0])

    # the known-good noise draw of the JAX check: at these toy LWE dims
    # some draws exceed the rounding budget even unsharded, so the
    # unsharded recover is verified before the sharded one is blamed
    qrng = np.random.default_rng(7)
    all_bits = np.unpackbits(bit_bytes, bitorder="little")[:num_entries]
    targets = [int(np.flatnonzero(all_bits == 1)[0]),
               int(np.flatnonzero(all_bits == 0)[0])]
    states, queries = [], []
    for t in targets:
        st, msg = scheme.query(t, shared, params, sharded.info, qrng)
        states.append(st)
        queries.append(msg)
    want = single.answer(queries)
    got = sharded.answer(queries)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    for k, t in enumerate(targets):
        rec_single = scheme.recover(t, k, hint_single, queries[k], want,
                                    shared, states[k], params, single.info)
        assert rec_single == int(all_bits[t]), (
            "seed no longer decodes unsharded (noise draw)", t, rec_single)
        rec = scheme.recover(t, k, hint_sharded, queries[k], got, shared,
                             states[k], params, sharded.info)
        assert rec == int(all_bits[t]), (t, rec)
