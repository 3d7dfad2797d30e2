"""The port's DCN front end (sdk_tpu_torch.server.dcn): instances split
over two port backends (SpiralKvServerTorch on the CPU, each behind the
port's HTTP service on a thread, as tests/test_dcn.py runs the JAX ones)
serve the same bytes as one port server holding every instance; a dead
backend is a 502 naming it; the sizing helpers equal the JAX package's."""

import base64
import bz2
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sdk_tpu import params as params_j
from sdk_tpu.server import dcn as dcn_j
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.kv.key_value import extract_result, row_from_key
from sdk_tpu_torch.params import params_from_json, params_from_json_obj
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.dcn import (DcnFrontend, backend_params_obj,
                                      response_segment_bytes,
                                      serve as dcn_serve)
from sdk_tpu_torch.server.http import serve as http_serve
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

torch.set_num_threads(1)
PARAMS_JSON = ('{"n": 2, "nu_1": 6, "nu_2": 2, "p": 256, "q2_bits": 20,'
               ' "t_gsw": 8, "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8,'
               ' "instances": 2, "db_item_size": 16384}')


@pytest.fixture(scope="module")
def topology():
    params = params_from_json(PARAMS_JSON)
    b_obj = backend_params_obj(params, 2)
    assert b_obj["instances"] == 1
    urls, httpds = [], []
    for _ in range(2):
        srv = SpiralKvServerTorch(params_from_json_obj(b_obj), "cpu")
        httpd = http_serve(srv, 0, block=False)
        httpds.append(httpd)
        urls.append(f"http://localhost:{httpd.server_address[1]}")
    fe = DcnFrontend(params, urls, PARAMS_JSON)
    single = SpiralKvServerTorch(params, "cpu", PARAMS_JSON)
    yield params, fe, single
    for h in httpds:
        h.shutdown()


def test_dcn_matches_single_server_byte_exact(topology):
    params, fe, single = topology
    rng = np.random.default_rng(6)
    kv = {f"key-{i}": base64.b64encode(
        rng.integers(0, 256, 500, dtype=np.uint8).tobytes()).decode()
        for i in range(5)}
    body = json.dumps(kv).encode()
    fe.write_kv(body)
    single.write_kv(body)
    client = Client(params)
    pp_raw = client.generate_keys_from_seed(
        b"\x31" * 32, noise_rng=ChaCha20Rng(b"\x32" * 32),
        pp_seed=b"\x33" * 32).serialize(params)
    uid = "11111111-2222-3333-4444-555555555555"
    fe.setup_raw(pp_raw, uid)
    single.setup_raw(pp_raw, uid)
    assert fe.has_uuid(uid)
    key = "key-3"
    query = client.generate_query(
        row_from_key(params.num_items(), key),
        noise_rng=ChaCha20Rng(b"\x38" * 32), query_seed=b"\x39" * 32)
    blob = uid.encode() + query.serialize(params)
    rd_body = json.dumps([base64.b64encode(blob).decode()]).encode()
    dcn_resp = json.loads(fe.private_read_body(rd_body))
    assert dcn_resp == json.loads(single.private_read(rd_body))
    decoded = client.decode_response(base64.b64decode(dcn_resp[0]))
    payload = bz2.BZ2Decompressor().decompress(decoded)
    assert extract_result(key, payload) == base64.b64decode(kv[key])


def test_dcn_front_end_http_surface(topology):
    params, fe, _ = topology
    httpd = dcn_serve(fe, 0, block=False)
    try:
        from sdk_tpu_torch.clients.bucket_service import connect_local

        bucket = connect_local(httpd.server_address[1])
        assert bucket.info()["dcn_backends"] == 2
        bucket.write({"dcn-key": b"served across hosts"})
        assert bucket.private_read(["dcn-key", "missing"]) == [
            b"served across hosts", None]
    finally:
        httpd.shutdown()


def test_dead_backend_is_a_502_naming_it(topology):
    params, fe, _ = topology
    with socket.socket() as s:
        s.bind(("localhost", 0))
        dead = f"http://localhost:{s.getsockname()[1]}"
    broken = DcnFrontend(params, [fe.urls[0], dead], PARAMS_JSON)
    httpd = dcn_serve(broken, 0, block=False)
    try:
        req = urllib.request.Request(
            f"http://localhost:{httpd.server_address[1]}/write",
            data=json.dumps({"k": base64.b64encode(b"v").decode()}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 502
        details = json.loads(e.value.read())
        assert list(details["failed_backends"]) == [dead]
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("cfg,n", [(PARAMS_JSON, 2), (PARAMS_JSON, 1),
                                   ('{"n": 2, "nu_1": 9, "nu_2": 5, "p": 256,'
                                    ' "q2_bits": 22, "t_gsw": 7, "t_conv": 3,'
                                    ' "t_exp_left": 5, "t_exp_right": 5,'
                                    ' "instances": 4, "db_item_size": 32768}',
                                    4)],
                         ids=["two-backends", "one-backend", "default-cfg"])
def test_sizing_helpers_match_jax(cfg, n):
    pt, pj = params_from_json(cfg), params_j.params_from_json(cfg)
    assert backend_params_obj(pt, n) == dcn_j.backend_params_obj(pj, n)
    assert response_segment_bytes(pt) == dcn_j.response_segment_bytes(pj)
