"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; every test skips when no CUDA device is present (decided
inside the fixture, never at import). Run on a machine with an H100:
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu``.
Integer results: the tolerance is 0. Besides the port it imports only the
JAX package's numpy host oracle (``sdk_tpu.server_host``), never jax, so it
runs where jax is not installed.
"""

import json

import numpy as np
import pytest
import torch

from sdk_tpu import client as client_j, params as params_j, server_host
from sdk_tpu_torch import _build
from sdk_tpu_torch.client import Client
from sdk_tpu_torch.kv.ingest import ingest_items_device
from sdk_tpu_torch.ops import ntt, spiral as sj
from sdk_tpu_torch.ops.encode import ResponseEncodePlan
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_to_json_obj)
from sdk_tpu_torch.rng import ChaCha20Rng
from sdk_tpu_torch.server.kv_server import SpiralKvServerTorch

pytestmark = pytest.mark.gpu
PARAMS = get_fast_expansion_testing_params()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def residues(rng, lead, params=PARAMS):
    x = np.stack([rng.integers(0, q, lead + (params.poly_len,))
                  for q in params.moduli], axis=-2)
    return torch.from_numpy(x.astype(np.int32))


def test_ntt_matches_plain(cuda):
    rng = np.random.default_rng(1)
    x = residues(rng, (96,))
    digits = torch.from_numpy(rng.integers(0, 1 << 19, (96, 2, 2048))
                              .astype(np.int32))
    for inp in (x, digits):
        got = ntt.ntt_forward(PARAMS, inp.to(cuda)).cpu()
        assert torch.equal(got, ntt.ntt_forward_plain(PARAMS, inp))
    got = ntt.ntt_inverse(PARAMS, x.to(cuda)).cpu()
    assert torch.equal(got, ntt.ntt_inverse_plain(PARAMS, x))
    torch.cuda.synchronize()


@pytest.mark.parametrize("keyed", [False, True])
def test_matmul_mod_matches_plain(cuda, keyed):
    rng = np.random.default_rng(2)
    a = residues(rng, (3, 2, 28))            # per-query key batch of 3
    b = residues(rng, (3, 5, 28, 1))
    a_arg = a
    if keyed:
        from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

        a_arg = (a, u32_bits(shoup_companion_arr(
            PARAMS, a.numpy().astype(np.uint64)), "cpu"))
    want = sj.matmul_mod_plain(PARAMS, a, b)
    dev = tuple(t.to(cuda) for t in a_arg) if keyed else a_arg.to(cuda)
    got = sj.matmul_mod(PARAMS, dev, b.to(cuda)).cpu()
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", [2, 6, 8, 32, 34, 64])
def test_scan_matches_plain(cuda, R):
    rng = np.random.default_rng(3)
    vals = np.stack([rng.integers(0, q, (64, 1, 4, 4, 64))
                     for q in PARAMS.moduli])
    db = sj.db_limbs(PARAMS, torch.from_numpy(vals))
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (64, 64, R)) for q in PARAMS.moduli]
    ).astype(np.int32))
    got = sj.firstdim_multiply(PARAMS, db.to(cuda), q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_plain(PARAMS, db, q_arr))


@pytest.mark.parametrize("R", [2, 6, 32])
@pytest.mark.parametrize("cap", [8, 16])
def test_scan_compact_matches_plain(cuda, cap, R):
    """Kernel I: random limbs and slot columns, a zero (unoccupied) slot
    tail in every bin."""
    rng = np.random.default_rng(6)
    npr, dim0 = 4, 64
    vals = np.stack([rng.integers(0, q, (64, 1, 4, npr, cap))
                     for q in PARAMS.moduli])
    vals[..., cap - 3:] = 0
    idx_j = np.stack([rng.permutation(dim0)[:cap] for _ in range(npr)])
    idx_j[:, cap - 3:] = 0
    db = sj.CompactDb(sj.db_limbs(PARAMS, torch.from_numpy(vals)),
                      torch.from_numpy(idx_j.astype(np.int32)))
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (64, dim0, R)) for q in PARAMS.moduli]
    ).astype(np.int32))
    got = sj.firstdim_multiply(PARAMS, sj.CompactDb(
        db.planes.to(cuda), db.idx_j.to(cuda)), q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_compact_plain(PARAMS, db,
                                                               q_arr))


@pytest.mark.parametrize("side", ["left", "right"])
def test_expand_round_matches_plain(cuda, side):
    """Kernel E' at both key widths, zeros (negated to Q) included."""
    rng = np.random.default_rng(7)
    t_exp = PARAMS.t_exp_left if side == "left" else PARAMS.t_exp_right
    x = residues(rng, (5, 2, 1))
    x[0, :, :, :, :32] = 0
    x[3] = 0
    plan = sj.ExpansionPlan(PARAMS, cuda)
    for r in (0, 3):
        tables = plan.auto[r]
        got = sj.expand_round(PARAMS, x.to(cuda), tables, t_exp).cpu()
        cpu_tables = tuple(t.cpu() for t in tables)
        assert torch.equal(got, sj.expand_round_plain(PARAMS, x, cpu_tables,
                                                      t_exp))


def test_encode_matches_plain(cuda):
    rng = np.random.default_rng(4)
    plan_cpu = ResponseEncodePlan(PARAMS, "cpu")
    packed = torch.from_numpy(rng.integers(
        0, PARAMS.modulus, (PARAMS.instances, PARAMS.n + 1, PARAMS.n,
                            PARAMS.poly_len), dtype=np.int64))
    packed[0, 0, 0, :3] = torch.tensor([0, PARAMS.modulus - 1,
                                        PARAMS.modulus // 2])
    got = ResponseEncodePlan(PARAMS, cuda).encode(packed.to(cuda)).cpu()
    assert torch.equal(got, plan_cpu.encode(packed))


def test_ingest_matches_plain(cuda):
    rng = np.random.default_rng(5)
    raw = torch.from_numpy(rng.integers(0, 256, (3, 16, 2048), dtype=np.uint8))
    got = ingest_items_device(PARAMS, raw.to(cuda)).cpu()
    assert torch.equal(got, ingest_items_device(PARAMS, raw))


def _session(params, seed: int):
    client = Client(params)
    pp = client.generate_keys_from_seed(
        bytes([seed]) * 32, noise_rng=ChaCha20Rng(bytes([seed + 1]) * 32),
        pp_seed=bytes([seed + 2]) * 32)
    return client, pp


def test_full_protocol_on_card(cuda):
    """One whole response on the card equals the plain versions' on the
    CPU and the numpy host oracle's (sdk_tpu.server_host), over a dense
    index of random rows."""
    params = PARAMS
    params_h = params_j.params_from_json(json.dumps(params_to_json_obj(params)))
    client, pp = _session(params, 0x31)
    query = client.generate_query(
        9, noise_rng=ChaCha20Rng(b"\x34" * 32), query_seed=b"\x35" * 32)
    _, db = server_host.generate_random_db_and_get_item(params_h, 9)
    responses = []
    for device in (cuda, "cpu"):
        srv = SpiralServerTorch(params, device)
        srv.set_db_host_tensor(db)
        _build.reset_launches()
        responses.append(srv.process_query(pp, query))
        if device is cuda:
            counts = dict(_build.LAUNCHES)
    assert responses[0] == responses[1]
    assert responses[0] == server_host.process_query(
        params_h,
        client_j.PublicParameters.deserialize(params_h, pp.serialize(params)),
        client_j.Query.deserialize(params_h, query.serialize(params)), db)
    assert all(counts[k] > 0 for k in ("ntt_forward", "ntt_inverse",
                                       "matmul_mod", "scan", "encode",
                                       "expand_round")), counts


@pytest.mark.parametrize("state", ["S1", "S2", "S3"])
def test_bucket_lifecycle_on_card(cuda, state):
    """A bucket on the card and one on the CPU fed the same rows give the
    same bytes in each state; the card's compact reads launch I."""
    params = PARAMS
    rng = np.random.default_rng(9)
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    items = {"S1": [3, 70, 130], "S2": [9 * i for i in range(24)],
             "S3": list(range(0, 160, 4))}[state]
    client, pp = _session(params, 0x41)
    blob = None
    responses = []
    for device in (cuda, "cpu"):
        srv = SpiralKvServerTorch(params, device)
        for i in items:
            srv.update_item_raw(i, np.random.default_rng(i).integers(
                0, 256, row_len, dtype=np.uint8).tobytes())
        uid = srv.setup_raw(pp.serialize(params), "0" * 36)
        if blob is None:
            blob = uid.encode() + client.generate_query(
                items[1], noise_rng=ChaCha20Rng(b"\x44" * 32),
                query_seed=b"\x45" * 32).serialize(params)
        _build.reset_launches()
        responses.append(srv.private_read_one(blob))
        if device is cuda:
            counts = dict(_build.LAUNCHES)
            layout = srv.meta()["index_layout"]
    assert responses[0] == responses[1]
    assert layout == ("dense" if state == "S3" else "compact")
    assert (counts["scan_compact"] > 0) == (state != "S3"), counts
    assert counts["expand_round"] > 0, counts
