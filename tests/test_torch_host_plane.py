"""The port's own copy of the numpy host plane (sdk_tpu_torch.{params,
params_store, client, ntt_host, kv.key_value, kv.write}) against the JAX
package's, which it was copied from: same parameters, byte-identical setup
and query bytes from the same seeds, the same decode, the same NTTs and the
same key-value rows."""

import json

import numpy as np
import pytest

from sdk_tpu import client as client_j
from sdk_tpu import ntt_host as ntt_host_j
from sdk_tpu import params as params_j
from sdk_tpu import params_store as store_j
from sdk_tpu.kv import key_value as kv_j
from sdk_tpu.kv import write as write_j
from sdk_tpu.rng import ChaCha20Rng as RngJ
from sdk_tpu_torch import client, ntt_host, params_store
from sdk_tpu_torch import params as params_t
from sdk_tpu_torch.kv import key_value, write
from sdk_tpu_torch.ops.encode import ResponseEncodePlan
from sdk_tpu_torch.rng import ChaCha20Rng


def both_params(name: str):
    """(JAX Params, port Params) of one parameter set."""
    if name == "fast":
        return (params_j.get_fast_expansion_testing_params(),
                params_t.get_fast_expansion_testing_params())
    return store_j.get_params_from_store(15, 32768), \
        params_store.get_params_from_store(15, 32768)


@pytest.mark.parametrize("name", ["fast", "1gib"])
def test_params_identical(name):
    pj, pt = both_params(name)
    obj = params_t.params_to_json_obj(pt)
    assert obj == params_j.params_to_json_obj(pj)
    assert params_t.params_to_json_obj(
        params_t.params_from_json(json.dumps(obj))) == obj
    assert pt.moduli == pj.moduli and pt.modulus == pj.modulus
    assert (pt.setup_bytes(), pt.query_bytes(), pt.num_items()) == \
        (pj.setup_bytes(), pj.query_bytes(), pj.num_items())


def test_client_bytes_and_decode_identical():
    pj, pt = both_params("fast")
    cj, ct = client_j.Client(pj), client.Client(pt)
    ppj = cj.generate_keys_from_seed(b"\x41" * 32, noise_rng=RngJ(b"\x42" * 32),
                                     pp_seed=b"\x43" * 32)
    ppt = ct.generate_keys_from_seed(b"\x41" * 32,
                                     noise_rng=ChaCha20Rng(b"\x42" * 32),
                                     pp_seed=b"\x43" * 32)
    assert ppt.serialize(pt) == ppj.serialize(pj)
    qj = cj.generate_query(77, noise_rng=RngJ(b"\x44" * 32),
                           query_seed=b"\x45" * 32)
    qt = ct.generate_query(77, noise_rng=ChaCha20Rng(b"\x44" * 32),
                           query_seed=b"\x45" * 32)
    assert qt.serialize(pt) == qj.serialize(pj)
    # a response-sized byte string decodes identically
    n_bytes = ResponseEncodePlan(pt, "cpu").num_bytes
    resp = np.random.default_rng(3).integers(0, 256, n_bytes,
                                             dtype=np.uint8).tobytes()
    assert ct.decode_response(resp) == cj.decode_response(resp)
    # and both parse each other's bytes
    assert client.Query.deserialize(pt, qj.serialize(pj)).serialize(pt) == \
        qj.serialize(pj)
    assert client.PublicParameters.deserialize(
        pt, ppj.serialize(pj)).serialize(pt) == ppj.serialize(pj)


def test_ntt_host_identical():
    pj, pt = both_params("fast")
    rng = np.random.default_rng(5)
    x = np.stack([rng.integers(0, q, (3, pt.poly_len)) for q in pt.moduli],
                 axis=-2).astype(np.uint64)
    fwd = ntt_host.ntt_forward(pt, x)
    np.testing.assert_array_equal(fwd, ntt_host_j.ntt_forward(pj, x))
    np.testing.assert_array_equal(ntt_host.ntt_inverse(pt, fwd),
                                  ntt_host_j.ntt_inverse(pj, fwd))
    np.testing.assert_array_equal(ntt_host.ntt_inverse(pt, fwd), x)


def test_key_value_rows_identical():
    rows_t, rows_j = bytearray(), bytearray()
    body = json.dumps({"k1": "dmFsdWUx", "k2": "YWJj", "k3": "eHl6"}).encode()
    pairs = write.unwrap_kv_pairs(body)
    assert pairs == write_j.unwrap_kv_pairs(body)
    # an overwrite and a deletion (an empty value)
    for k, v in pairs + [("k1", b"other"), ("k2", b"")]:
        write.update_row(rows_t, k, v)
        write_j.update_row(rows_j, k, v)
    assert rows_t == rows_j
    assert write.compress_row(rows_t) == write_j.compress_row(rows_j)
    for k in ("k1", "k3"):
        assert key_value.row_from_key(1 << 15, k) == \
            kv_j.row_from_key(1 << 15, k)
        assert key_value.extract_result(k, bytes(rows_t)) == \
            kv_j.extract_result(k, bytes(rows_j))


def test_client_sdk_helpers_identical():
    """The copied client-side helpers (chunk and key/value framing, seed
    strings, the Merkle-proof tree helpers) against the JAX package's."""
    import hashlib

    from sdk_tpu.clients import proof as proof_j
    from sdk_tpu.clients import seed as seed_j
    from sdk_tpu.clients import serializer as ser_j
    from sdk_tpu_torch.clients import proof, seed, serializer

    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 127, 128, 70000)]
    blob = serializer.serialize_chunks(chunks)
    assert blob == ser_j.serialize_chunks(chunks)
    assert serializer.deserialize_chunks(blob) == chunks
    wrapped = serializer.wrap_key_val(b"key", chunks[3])
    assert wrapped == ser_j.wrap_key_val(b"key", chunks[3])
    assert serializer.unwrap_key_val(wrapped) == ser_j.unwrap_key_val(wrapped)
    raw = bytes(range(32))
    assert seed.string_from_seed(raw) == seed_j.string_from_seed(raw)
    assert seed.seed_from_string(seed.string_from_seed(raw)) == raw

    def h2(a: str, b: str) -> str:
        return "0x" + hashlib.sha256(bytes.fromhex(a[2:])
                                     + bytes.fromhex(b[2:])).hexdigest()

    leaves = ["0x" + hashlib.sha256(f"leaf{i}".encode()).hexdigest()
              for i in range(16)]
    levels = proof.build_tree_levels(leaves, h2)
    assert levels == proof_j.build_tree_levels(leaves, h2)
    assert proof.subtree_level_order(levels, 1, 1, 3) == \
        proof_j.subtree_level_order(levels, 1, 1, 3)
    cfg = dict(bucket_url="", api_key="", cap_url="", subtree_height=3,
               cap_height=2, tree_height=5)
    assert proof.get_subtree_indices(proof.LookupCfg(**cfg), 11) == \
        proof_j.get_subtree_indices(proof_j.LookupCfg(**cfg), 11)


def test_doublepir_cli_e2e_and_preprocess(tmp_path):
    """The copied DoublePIR command-line tools: the chunked e2e recovers its
    planted entries, and preprocess writes the files the JAX package's
    tool writes."""
    from sdk_tpu.doublepir import cli as cli_j
    from sdk_tpu_torch.doublepir import cli

    assert cli.main(["e2e", "12"]) == 0
    assert cli.main([]) == 2
    data = tmp_path / "bits.bin"
    data.write_bytes(np.random.default_rng(9).integers(
        0, 256, 512, dtype=np.uint8).tobytes())
    for mod, name in ((cli, "port"), (cli_j, "jax")):
        (tmp_path / name).mkdir()
        assert mod.main(["preprocess", "4096", "1", str(data),
                         str(tmp_path / name / "db")]) == 0
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files and files == sorted(p.name for p in
                                     (tmp_path / "jax").iterdir())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
