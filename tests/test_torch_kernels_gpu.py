"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; every test skips when no CUDA device is present (decided
inside the fixture, never at import). Run on a machine with an H100:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``.
Integer results: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from sdk_tpu import server_host
from sdk_tpu.client import Client
from sdk_tpu.params import get_fast_expansion_testing_params
from sdk_tpu.rng import ChaCha20Rng
from sdk_tpu_torch import _build
from sdk_tpu_torch.ops import ntt, spiral as sj
from sdk_tpu_torch.ops.encode import ResponseEncodePlan
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.kv.ingest import ingest_items_device

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


def test_full_protocol_on_card(cuda):
    params = PARAMS
    client = Client(params)
    pp = client.generate_keys_from_seed(
        b"\x31" * 32, noise_rng=ChaCha20Rng(b"\x32" * 32), pp_seed=b"\x33" * 32)
    query = client.generate_query(
        9, noise_rng=ChaCha20Rng(b"\x34" * 32), query_seed=b"\x35" * 32)
    _, db = server_host.generate_random_db_and_get_item(params, 9)
    srv = SpiralServerTorch(params, cuda)
    srv.set_db_host_tensor(db)
    _build.reset_launches()
    got = srv.process_query(pp, query)
    assert got == server_host.process_query(params, pp, query, db)
    assert all(v > 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES
