"""The whole private-read slice of the port (SpiralServerTorch,
plain versions on the CPU) against the JAX engine.

Both engines serve one identical DB and key set, carried across with
sdk_tpu_torch.convert; responses must be byte-identical and decode. The
port's Params come from the port's own params module; the JAX side gets the
JAX package's Params of the same JSON (J).
"""

import json

import pytest
import torch

from sdk_tpu import poly, server_host
from sdk_tpu.arith import log2_ceil
from sdk_tpu.client import Client, PublicParameters, Query
from sdk_tpu.ops.server_jax import SpiralServerJax, pp_to_device
from sdk_tpu import params as params_j
from sdk_tpu.rng import ChaCha20Rng
from sdk_tpu_torch import convert
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
# tests/test_spiral_variants.py:17 — the 1 GiB bucket's crypto shapes
V1_SMALL = params_from_json(
    '{"n": 2, "nu_1": 5, "nu_2": 2, "p": 256, "q2_bits": 22,'
    ' "t_gsw": 7, "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5,'
    ' "instances": 2, "db_item_size": 16384, "version": 1}')


def J(params):
    """The JAX package's Params of the same JSON as the port's ``params``."""
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


def session(params, seed: int):
    """A JAX-package client session (its bytes equal the port client's,
    tests/test_torch_host_plane.py)."""
    params = J(params)
    c = Client(params)
    pp = c.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)
    return c, PublicParameters.deserialize(params, pp.serialize(params))


def query_for(params, client, idx: int, seed: int) -> Query:
    params = J(params)
    q = client.generate_query(idx, noise_rng=ChaCha20Rng(bytes([seed]) * 32),
                              query_seed=bytes([seed + 1]) * 32)
    return Query.deserialize(params, q.serialize(params))


def item_bytes(params, item) -> bytes:
    return poly.raw_to_bytes(J(params), item, log2_ceil(params.pt_modulus),
                             params.modp_words_per_chunk())


@pytest.mark.parametrize("params", [FAST, V1_SMALL], ids=["fast-v0", "v1-small"])
def test_response_matches_jax_engine(params):
    """One DB and one key set in both engines: byte-identical responses
    that decode to the planted item."""
    target = 23 % params.num_items()
    client, pp = session(params, 0x21)
    query = query_for(params, client, target, 0x24)
    item, db = server_host.generate_random_db_and_get_item(J(params), target)
    srv_jax = SpiralServerJax(J(params))
    srv_jax.set_db_host_tensor(db)
    want = srv_jax.process_query(pp, query)

    srv = SpiralServerTorch(params, "cpu")
    srv.set_db(convert.db_from_jax_planes(params, srv_jax.db))
    got = srv.process_query(convert.pp_from_jax(pp_to_device(J(params), pp)),
                            query)
    assert got == want
    assert client.decode_response(got) == item_bytes(params, item)


def test_batched_matches_single():
    """NQ = 3 (padded to 4 scan column pairs) from two sessions: every
    response equals the single-query response and decodes."""
    params = FAST
    _, db = server_host.generate_random_db_and_get_item(J(params), 0)
    srv = SpiralServerTorch(params, "cpu")
    srv.set_db_host_tensor(db)
    reqs, clients, targets = [], [], [5, 77, 200]
    for i, idx in enumerate(targets):
        client, pp = session(params, 0x30 + 4 * (i // 2))
        clients.append(client)
        reqs.append((srv._pp_dev(pp) if i % 2 == 0 else pp,
                     query_for(params, client, idx, 0x40 + 2 * i)))
    fetch = srv.dispatch_queries_batched(reqs)
    single = [srv.process_query(pp, q) for pp, q in reqs]
    batched = fetch()
    assert batched == single
    items = server_host.generate_random_db_and_get_item
    for client, idx, resp in zip(clients, targets, batched):
        item, _ = items(J(params), idx)
        assert client.decode_response(resp) == item_bytes(params, item)
