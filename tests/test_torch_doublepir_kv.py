"""The checklist bucket of the port (DoublePirKvServerTorch, plain versions
on the CPU) against the JAX bucket (DoublePirKvServer(use_device=True)):
the same keys and the same query bytes give the same hint bytes and answer
bytes, for a byte-element config (the device engine) and a p=991 config
(the general branch), through save/restore and over the HTTP handler. The
tolerance is 0: bytes are compared."""

import base64
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sdk_tpu.doublepir import params as params_j
from sdk_tpu.server.doublepir_server import DoublePirKvServer
from sdk_tpu_torch.clients.bloom import bloom_hash
from sdk_tpu_torch.doublepir.client import DoublePirClient
from sdk_tpu_torch.doublepir.params import Params
from sdk_tpu_torch.doublepir.serializer import serialize_states
from sdk_tpu_torch.server import doublepir_server as ds
from sdk_tpu_torch.server.doublepir_server import (BLOOM_K,
                                                   DoublePirKvServerTorch,
                                                   serve_doublepir)

torch.set_num_threads(1)
LOG2M = 10
CONFIGS = {"byte-element": "64,6.4,13,17,32,464",
           "general-p991": "64,6.4,16,16,32,991"}
KEYS = ["alpha", "beta", "gamma"]


def make_pair(config: str):
    port = DoublePirKvServerTorch(LOG2M, Params.from_string(CONFIGS[config]),
                                  device="cpu")
    ref = DoublePirKvServer(LOG2M, params_j.Params.from_string(CONFIGS[config]),
                            use_device=True)
    port.add_keys(KEYS)
    ref.add_keys(KEYS)
    return port, ref


def query_bytes(srv, key: str, seed: int):
    """One 8-query batch for ``key``, as Bucket.check_inclusion sends it."""
    meta = srv.meta()["pir_scheme"]
    client = DoublePirClient.from_strings(meta["params"], meta["dbinfo"])
    client.load_hint(srv.get_hint())
    idxs = [bloom_hash(key, i, LOG2M) for i in range(BLOOM_K)]
    queries, datas, plan = client.generate_query_batch(
        idxs, np.random.default_rng(seed))
    return client, serialize_states(queries), datas, plan


def decoded_bits(client, raw, datas, plan) -> list[int]:
    return [client.decode_response(raw, e[0], b, datas[b])
            for b, e in enumerate(plan) if e is not None]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_hint_and_answer_bytes_match_jax_bucket(config):
    port, ref = make_pair(config)
    assert port.get_hint() == ref.get_hint()
    assert port.meta() == ref.meta()
    assert port.hint_meta() == ref.hint_meta()
    assert port.hint_chunk(0) == ref.hint_chunk(0)
    with pytest.raises(KeyError):
        port.hint_chunk(99)
    assert (port._engine is not None) == (config == "byte-element")
    assert (ref._engine is not None) == (config == "byte-element")
    client, qb, datas, plan = query_bytes(port, "alpha", 51)
    raw = port.answer(qb)
    assert raw == ref.answer(qb)
    # a member's planned bloom bits all decode to 1
    assert set(decoded_bits(client, raw, datas, plan)) == {1}
    # a direct bit insert is served after the rebuild, as in the JAX bucket
    free = next(i for i in range(1 << LOG2M)
                if not port.bit_bytes[i >> 3] & (1 << (i & 7)))
    for srv in (port, ref):
        srv.set_bit(free)
    assert port.get_hint() == ref.get_hint()
    client.load_hint(port.get_hint())
    one, data = client.generate_query(free, np.random.default_rng(52))
    raw = port.answer(serialize_states([ds.deserialize_state(one)[0]]))
    assert client.decode_response(raw, free, 0, data) == 1


@pytest.mark.parametrize("config", list(CONFIGS))
def test_save_restore_matches_jax_bucket(config, tmp_path):
    port, ref = make_pair(config)
    hint = port.get_hint()
    port.save_to_dir(str(tmp_path / "port"))
    ref.save_to_dir(str(tmp_path / "ref"))
    for name in ("bit_bytes.npy", "keys.json", "hint.bin", "meta.json") \
            + (("h1_sq.npy",) if config == "byte-element" else ()):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes(), name
    # the port restores from the JAX bucket's checkpoint
    back = DoublePirKvServerTorch(LOG2M, Params.from_string(CONFIGS[config]),
                                  device="cpu")
    back.restore_from_dir(str(tmp_path / "ref"))
    if config == "byte-element":
        assert back._engine is not None and not back._dirty, \
            "restore should install the saved hint, not schedule a rebuild"
    assert back.get_hint() == hint
    assert back.keys == port.keys and back.version == port.version
    _, qb, _, _ = query_bytes(port, "gamma", 53)
    assert back.answer(qb) == port.answer(qb) == ref.answer(qb)
    with pytest.raises(ValueError):
        DoublePirKvServerTorch(LOG2M + 1, device="cpu").restore_from_dir(
            str(tmp_path / "ref"))


def test_restore_config_mismatch_rebuilds(tmp_path):
    """A checkpoint whose hint artifacts don't match the restoring server's
    engine config falls back to rebuilding from the bloom bits."""
    port, _ = make_pair("byte-element")
    port.save_to_dir(str(tmp_path / "ck"))
    h1 = np.load(tmp_path / "ck" / "h1_sq.npy")
    np.save(tmp_path / "ck" / "h1_sq.npy", h1[:, :-1])
    back = DoublePirKvServerTorch(
        LOG2M, Params.from_string(CONFIGS["byte-element"]), device="cpu")
    back.restore_from_dir(str(tmp_path / "ck"))
    assert back._dirty, "mismatched artifact must schedule a rebuild"
    assert back.get_hint() == port.get_hint()


def test_mesh_is_refused_and_the_card_is_the_default():
    # a mesh is an ops.shard.Mesh; --mesh wants as many cards as it names
    with pytest.raises(TypeError, match="Mesh"):
        DoublePirKvServerTorch(LOG2M, mesh=object())
    assert DoublePirKvServerTorch(LOG2M).device.type == "cuda"
    if torch.cuda.device_count() < 4:
        with pytest.raises(SystemExit):
            ds.main(["8000", "10", "--mesh", "dp=1,db=4"])
    with pytest.raises(SystemExit):
        ds.main(["8000"])


def test_default_params_and_warmup():
    srv = DoublePirKvServerTorch(LOG2M, device="cpu")
    assert srv.params.to_string() == DoublePirKvServer(LOG2M).params.to_string()
    assert srv.warmup() >= 0
    assert srv.hint_meta()["hint_num_chunks"] >= 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, body: bytes | None = None):
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=body)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_http_handler_serves_the_jax_buckets_bytes():
    port_srv, ref = make_pair("byte-element")
    port = _free_port()
    httpd = serve_doublepir(port_srv, port, block=False)
    try:
        assert json.loads(_http(port, "/meta")) == ref.meta()
        assert json.loads(_http(port, "/hint-meta")) == ref.hint_meta()
        assert base64.b64decode(json.loads(_http(port, "/hint"))["hint"]) \
            == ref.get_hint()
        assert _http(port, "/hint/chunk/0") == ref.hint_chunk(0)
        for bad in ("/hint/chunk/7", "/nothing"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _http(port, bad)
            assert e.value.code == 404
        # a write over HTTP, then a member and a non-member through the
        # client's batch plan: a member's planned bloom bits are all set, a
        # non-member's are not
        assert b"done" in _http(port, "/write", json.dumps(["delta"]).encode())
        ref.add_keys(["delta"])
        for key, member in (("delta", True), ("not-a-member-xyz", False)):
            client, qb, datas, plan = query_bytes(port_srv, key, 54)
            body = json.dumps([base64.b64encode(qb).decode()]).encode()
            raw = base64.b64decode(json.loads(_http(port, "/private-read",
                                                    body))[0])
            assert raw == ref.answer(qb)
            bits = decoded_bits(client, raw, datas, plan)
            assert bits and (0 not in bits) == member
        with pytest.raises(urllib.error.HTTPError) as e:
            _http(port, "/private-read", b"not json")
        assert e.value.code == 500
    finally:
        httpd.shutdown()
        httpd.server_close()
