"""The CLIENT_TEST noise-localization hook on the port (the cases of
tests/test_debug_hooks.py): with the client's secret key and the right
plaintext planted, a single read decrypts its instance-0 / trial-0 folded
ct after the fold and answers the same bytes as without the hook; a wrong
plaintext raises ClientTestFailure before kernel G (pack + encode) runs, for
expansion and direct-upload queries and over a logical CPU mesh; batches of
more than one are served without the check (server_jax.py:654). Seeded
inputs; tolerance 0."""

import functools
import json

import numpy as np
import pytest
import torch

from sdk_tpu import client as client_j, params as params_j, server_host
from sdk_tpu_torch import debug_hooks
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.ops import spiral as sj
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.ops.shard import make_mesh
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng

torch.set_num_threads(1)
FAST = get_fast_expansion_testing_params()
DIRECT = params_from_json(
    '{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
    ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
    ' "t_exp_right": 8}')


def J(params):
    return params_j.params_from_json(json.dumps(params_to_json_obj(params)))


@pytest.fixture(autouse=True)
def _clear_hook():
    yield
    debug_hooks.clear_client_test()


@pytest.fixture
def pack_calls(monkeypatch):
    """Counts the engine's calls of pack_encode (kernel G on a card)."""
    calls = []
    pack_encode = sj.pack_encode

    def counted(*args, **kwargs):
        calls.append(1)
        return pack_encode(*args, **kwargs)

    monkeypatch.setattr(sj, "pack_encode", counted)
    return calls


@functools.lru_cache(maxsize=None)
def setup(direct: bool):
    """A seeded session of DIRECT or FAST, its query for item 37 (mod the
    items) and server_host's random DB; made once a params set (the
    expansion and mesh cases share FAST's)."""
    params = DIRECT if direct else FAST
    target = 37 % params.num_items()
    client = Client(params)
    pp = client.generate_keys_from_seed(
        b"\x16" * 32, noise_rng=ChaCha20Rng(b"\x17" * 32),
        pp_seed=b"\x1a" * 32)
    query = client.generate_query(
        target, noise_rng=ChaCha20Rng(b"\x18" * 32), query_seed=b"\x19" * 32)
    item, db = server_host.generate_random_db_and_get_item(J(params), target)
    return client, pp, query, item, db


@pytest.mark.parametrize("kind", ["expansion", "direct", "mesh"])
def test_client_test_hook_passes_and_localizes_failure(kind, pack_calls):
    params = DIRECT if kind == "direct" else FAST
    client, pp, query, item, db = setup(kind == "direct")
    mesh = (make_mesh(4, dp=2, devices=[torch.device("cpu")] * 4)
            if kind == "mesh" else None)
    srv = SpiralServerTorch(params, "cpu", mesh=mesh)
    srv.set_db_host_tensor(db)
    plain = srv.process_query(pp, query)
    if kind == "expansion":
        pj = J(params)
        assert plain == server_host.process_query(
            pj, client_j.PublicParameters.deserialize(pj, pp.serialize(params)),
            client_j.Query.deserialize(pj, query.serialize(params)), db)

    # the right target: the hook runs and the bytes do not change
    debug_hooks.set_client_test(client.sk_reg, item[0, 0])
    pack_calls.clear()
    assert srv.process_query(pp, query) == plain
    assert pack_calls == [1]

    # a wrong target: the failure is localized before pack + encode
    bad = (item[0, 0] + 1) % np.uint64(params.pt_modulus)
    debug_hooks.set_client_test(client.sk_reg, bad)
    pack_calls.clear()
    with pytest.raises(debug_hooks.ClientTestFailure) as ei:
        srv.process_query(pp, query)
    assert np.isfinite(ei.value.noise_width_log2)
    assert pack_calls == []
    if kind == "direct":
        # a batch of two is served without the check (server_jax.py:654)
        assert srv.dispatch_queries_batched([(pp, query)] * 2)() == [plain] * 2


def test_dec_to_raw_measures_noise():
    params = FAST
    rng = np.random.default_rng(9)
    p = params.pt_modulus
    scale_k = params.modulus // p
    target = rng.integers(0, p, (1, 1, params.poly_len), dtype=np.uint64)
    centered = np.where(target >= p // 2,
                        target.astype(np.int64) - p, target.astype(np.int64))
    noise = rng.integers(-int(scale_k // 4), int(scale_k // 4),
                         target.shape, dtype=np.int64)
    dec = (centered * scale_k + noise) % params.modulus
    rounded, width = debug_hooks.dec_to_raw(params, dec.astype(np.uint64),
                                            target)
    np.testing.assert_array_equal(rounded, target)
    assert width < 2 * np.log2(float(scale_k))
