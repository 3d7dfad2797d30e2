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
from sdk_tpu_torch.kv import ingest as ingest_t
from sdk_tpu_torch.kv.ingest import ingest_items_device
from sdk_tpu_torch.ops import ntt, spiral as sj
from sdk_tpu_torch.ops.encode import ResponseEncodePlan
from sdk_tpu_torch.ops.server import SpiralServerTorch
from sdk_tpu_torch.params import (get_fast_expansion_testing_params,
                                  params_from_json, params_to_json_obj)
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


@pytest.mark.parametrize("count", [1, 2, 3, 24, 96, 6144, 8192])
def test_ntt_matches_plain(cuda, count):
    """A and A' on (count, 2, n) residues and digit-range inputs, against
    the plain versions on the card."""
    rng = np.random.default_rng(1)
    x = residues(rng, (count,)).to(cuda)
    digits = torch.from_numpy(rng.integers(0, 1 << 19, (count, 2, 2048))
                              .astype(np.int32)).to(cuda)
    want_f = [ntt.ntt_forward_plain(PARAMS, inp) for inp in (x, digits)]
    want_i = ntt.ntt_inverse_plain(PARAMS, x)
    for inp, want in zip((x, digits), want_f):
        assert torch.equal(ntt.ntt_forward(PARAMS, inp), want)
    assert torch.equal(ntt.ntt_inverse(PARAMS, x), want_i)
    torch.cuda.synchronize()


def test_ntt_forward_takes_any_u32(cuda):
    """Inputs over the whole uint32 range (4q and above are reduced on
    load), with the extremes planted."""
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 32, (64, 2, 2048), dtype=np.uint64)
    q0, q1 = PARAMS.moduli
    x[0, :, :6] = [0, 4 * q0 - 1, 4 * q0, 4 * q1, (1 << 31), (1 << 32) - 1]
    inp = torch.from_numpy(x.astype(np.uint32).view(np.int32))
    got = ntt.ntt_forward(PARAMS, inp.to(cuda)).cpu()
    assert torch.equal(got, ntt.ntt_forward_plain(PARAMS, inp))


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


# (z, instances, trials, num_per, dim0): JW = dim0 / 4 words of dim0, M =
# instances * trials * num_per rows
_SCAN_SHAPES = {"base": (64, 1, 4, 64, 64), "jw1": (8, 1, 4, 16, 4),
                "jw2": (8, 1, 4, 16, 8), "jw3": (8, 1, 4, 16, 12),
                "m8": (8, 1, 1, 8, 64)}


@pytest.mark.parametrize("R", [2, 6, 8, 32, 34, 64])
@pytest.mark.parametrize("shape", list(_SCAN_SHAPES))
def test_scan_matches_plain(cuda, shape, R):
    """Kernel C (int8 tensor-core MMA): the base shape and the tails, JW
    not a multiple of 8 words (a k32 step) and M not a multiple of 16."""
    z, inst, trials, npr, dim0 = _SCAN_SHAPES[shape]
    rng = np.random.default_rng(3)
    vals = np.stack([rng.integers(0, q, (z, inst, trials, npr, dim0))
                     for q in PARAMS.moduli])
    db = sj.db_limbs(PARAMS, torch.from_numpy(vals))
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (z, dim0, R)) for q in PARAMS.moduli]
    ).astype(np.int32))
    got = sj.firstdim_multiply(PARAMS, db.to(cuda), q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_plain(PARAMS, db, q_arr))


@pytest.mark.parametrize("R", [2, 32])
def test_scan_weight_group_bound(cuda, R):
    """dim0 = 2^15 with every limb of both operands 127: the weight group
    s = 3 sums 4 * 127^2 * 2^15 = 2,114,060,288 < 2^31 in int32, and the
    query limbs span more k32 steps than shared memory holds at once."""
    dim0 = 1 << 15
    full = (1 << 28) - 1              # four limbs of 127
    vals = np.full((2, 2, 1, 1, 16, dim0), full, dtype=np.int64)
    db = sj.db_limbs(PARAMS, torch.from_numpy(vals))
    assert int(db.min()) == int(db.max()) == 127
    q_arr = torch.full((2, 2, dim0, R), full, dtype=torch.int32)
    got = sj.firstdim_multiply(PARAMS, db.to(cuda), q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_plain(PARAMS, db, q_arr))


@pytest.mark.parametrize("ntw", [1, 2, 4])
def test_scan_tilings_match_plain(cuda, ntw):
    """Every compiled form of kernel C (1, 2 or 4 tiles a warp) at R = 32
    over JW = 27 words (a tail of 3 in the last k32 step) and 24 rows: as
    tiled, with the query limbs refilled every iteration, and with one block
    along m whose warps take their m16 tiles one after another."""
    rng = np.random.default_rng(4)
    vals = np.stack([rng.integers(0, q, (4, 1, 3, 8, 108))
                     for q in PARAMS.moduli])
    db = sj.db_limbs(PARAMS, torch.from_numpy(vals))
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (4, 108, 32)) for q in PARAMS.moduli]
    ).astype(np.int32))
    want = sj.firstdim_multiply_plain(PARAMS, db, q_arr)
    base = sj.scan_tiling(32, 24, 4, 27, ntw=ntw, warps=2)
    for tl in (base, base._replace(kc=2),
               base._replace(bx=1, mtw=-(-2 // base.wm))):
        got = sj._scan_launch(PARAMS, db.to(cuda), q_arr.to(cuda), tl).cpu()
        assert torch.equal(got, want), tl


def _compact_case(rng, rows, npr, cap, dim0, R, z=16, full=False):
    """A compact index of rows = instances x trials rows a bin: random limbs
    and slot columns with a zero (unoccupied, idx 0) slot tail in every bin
    and an occupied slot at column 0 in bin 0, or every limb 127."""
    inst, trials = rows // 4, 4
    if full:
        vals = np.full((2, z, inst, trials, npr, cap), (1 << 28) - 1)
        q_arr = np.full((2, z, dim0, R), (1 << 28) - 1)
    else:
        vals = np.stack([rng.integers(0, q, (z, inst, trials, npr, cap))
                         for q in PARAMS.moduli])
        vals[..., cap - 3:] = 0
        q_arr = np.stack([rng.integers(0, q, (z, dim0, R))
                          for q in PARAMS.moduli])
    idx_j = np.stack([rng.choice(dim0, cap, replace=cap > dim0)
                      for _ in range(npr)])
    if not full:
        idx_j[:, cap - 3:] = 0
        idx_j[0, 0] = 0
    db = sj.CompactDb(sj.db_limbs(PARAMS, torch.from_numpy(vals)),
                      torch.from_numpy(idx_j.astype(np.int32)))
    return db, torch.from_numpy(q_arr.astype(np.int32))


def _compact_on(db, cuda):
    return sj.CompactDb(db.planes.to(cuda), db.idx_j.to(cuda))


@pytest.mark.parametrize("R", [2, 6, 32, 34])
@pytest.mark.parametrize("cap", [8, 16, 128])
@pytest.mark.parametrize("rows", [4, 16, 24])
def test_scan_compact_matches_plain(cuda, rows, cap, R):
    """Kernel I: rows a bin 4, 16 (one m16 tile) and 24 (two, the second
    half empty), caps below one k32 step and of four, R from one read to
    past one column block, 12 bins (a partial group of 8)."""
    rng = np.random.default_rng(6 + rows + cap + R)
    db, q_arr = _compact_case(rng, rows, 12, cap, 256, R)
    got = sj.firstdim_multiply(PARAMS, _compact_on(db, cuda),
                               q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_compact_plain(PARAMS, db,
                                                               q_arr))


def test_scan_compact_column_zero_beside_unoccupied_slots(cuda):
    """An occupied slot at column 0 beside unoccupied zero slots whose idx_j
    is 0 too: only the occupied one adds."""
    z, npr, cap, dim0, R = 4, 8, 8, 64, 32
    vals = np.zeros((2, z, 1, 4, npr, cap), dtype=np.int64)
    vals[:, :, :, :, :, 0] = 12345
    vals[:, :, :, :, 3, 5] = 777
    idx_j = np.zeros((npr, cap), dtype=np.int32)
    idx_j[3, 5] = 9
    rng = np.random.default_rng(11)
    q_arr = torch.from_numpy(np.stack(
        [rng.integers(0, q, (z, dim0, R)) for q in PARAMS.moduli]
    ).astype(np.int32))
    db = sj.CompactDb(sj.db_limbs(PARAMS, torch.from_numpy(vals)),
                      torch.from_numpy(idx_j))
    got = sj.firstdim_multiply(PARAMS, _compact_on(db, cuda),
                               q_arr.to(cuda)).cpu()
    want = sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr)
    assert torch.equal(got, want)
    assert int(want.abs().sum()) > 0


@pytest.mark.parametrize("R", [2, 32])
def test_scan_compact_widest_dim0_all_limbs_127(cuda, R):
    """The widest dim0 a block's shared memory takes at this R, every limb
    of both operands 127, cap 2^15 (the int32 weight-group bound)."""
    dim0 = max(d for d in range(1, 25000)
               if sj.compact_scan_smem(2, d, 2) <= sj._COMPACT_SMEM)
    tl = sj.compact_scan_tiling(R, 8, dim0, 1 << 15)
    assert sj.compact_scan_smem(tl.rb, dim0, tl.ns) <= sj._COMPACT_SMEM
    db, q_arr = _compact_case(np.random.default_rng(12), 4, 8, 1 << 15, dim0,
                              R, z=2, full=True)
    got = sj.firstdim_multiply(PARAMS, _compact_on(db, cuda),
                               q_arr.to(cuda)).cpu()
    assert torch.equal(got, sj.firstdim_multiply_compact_plain(PARAMS, db,
                                                               q_arr))


@pytest.mark.parametrize("ntw", [1, 2, 4])
def test_scan_compact_tilings_match_plain(cuda, ntw):
    """Every compiled form of kernel I (1, 2 or 4 tiles a warp) at R = 34
    over 24 rows a bin, cap 44 and 20 bins (a partial group of 8): the
    default column block of the form, its narrowest (rb = 2) with two
    stages and 4-byte copies, and one bin group a block with three."""
    rng = np.random.default_rng(13 + ntw)
    db, q_arr = _compact_case(rng, 24, 20, 44, 96, 34, z=4)
    want = sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr)
    dbc, qc = _compact_on(db, cuda), q_arr.to(cuda)
    for tl in (sj.compact_scan_tiling(34, 20, 96, 44, ntw=ntw),
               sj.compact_scan_tiling(34, 20, 96, 44, ntw=ntw, rb=2, ns=2,
                                      vec=0),
               sj.compact_scan_tiling(34, 20, 96, 44, ntw=ntw, gpb=1, ns=3)):
        got = sj._scan_compact_launch(PARAMS, dbc, qc, tl).cpu()
        assert torch.equal(got, want), tl


@pytest.mark.parametrize("cap", [8, 16])
def test_scan_compact_stage_widths(cuda, cap):
    """Caps 8 and 16 with their narrow stages (2 / 4 slot words of 32 / 16
    bins) and with the full one (8 words of 8 bins), 40 bins (a partial
    group) and 24 rows a bin."""
    rng = np.random.default_rng(15 + cap)
    db, q_arr = _compact_case(rng, 24, 40, cap, 64, 32, z=4)
    want = sj.firstdim_multiply_compact_plain(PARAMS, db, q_arr)
    dbc, qc = _compact_on(db, cuda), q_arr.to(cuda)
    narrow = sj.compact_scan_tiling(32, 40, 64, cap)
    assert narrow.sw == cap // 4
    for tl in (narrow, narrow._replace(vec=0),
               sj.compact_scan_tiling(32, 40, 64, cap, sw=8)):
        got = sj._scan_compact_launch(PARAMS, dbc, qc, tl).cpu()
        assert torch.equal(got, want), tl


def test_scan_compact_unaligned_bins(cuda):
    """num_per 6: rows of bins not 16-byte aligned take 4-byte copies."""
    rng = np.random.default_rng(14)
    db, q_arr = _compact_case(rng, 16, 6, 36, 80, 10, z=4)
    assert sj.compact_scan_tiling(10, 6, 80, 36).vec == 0
    got = sj.firstdim_multiply(PARAMS, _compact_on(db, cuda),
                               q_arr.to(cuda)).cpu()
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
        tables = plan.auto(r)
        got = sj.expand_round(PARAMS, x.to(cuda), tables, t_exp).cpu()
        cpu_tables = tuple(t.cpu() for t in tables)
        assert torch.equal(got, sj.expand_round_plain(PARAMS, x, cpu_tables,
                                                      t_exp))


def _expansion_key_sets(params, rng, nq, device):
    """nq random key sets, each a key dict with its own keyed (w, w')
    expansion matrices on ``device`` (left and right, a round each)."""
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    sets = []
    for _ in range(nq):
        d = {}
        for name, t in (("v_exp_left", params.t_exp_left),
                        ("v_exp_right", params.t_exp_right)):
            d[name] = []
            for _ in range(params.g()):
                m = residues(rng, (2, t), params).numpy().astype(np.uint64)
                d[name].append((u32_bits(m, device), u32_bits(
                    shoup_companion_arr(params, m), device)))
        sets.append(d)
    return sets


def _plant_zeros(params, cts):
    """Row 0 of query 0's first entry all zero (its automorphism negates
    zeros to Q), and the last query's last entry the NTT of a polynomial
    with 64 zero coefficients in each row."""
    cts[0, 0, 0] = 0
    raw = torch.from_numpy(np.random.default_rng(5).integers(
        0, params.modulus, (2, 1, params.poly_len)))
    raw[:, :, :64] = 0
    cts[-1, -1] = sj._to_ntt_plain(params, raw).to(cts.device)


@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("params", ["t_exp8", "t_exp5", "t_exp1,3"])
def test_expansion_matches_plain(cuda, params, nq):
    """Kernel E on every round of the dense and of a sparse schedule (an S1
    population: one first-dim row in eight), nq queries with their own
    keys, zeros planted, against expansion_round_plain on the card: at the
    default tiling (one launch a round) and at every cluster form."""
    params = {"t_exp8": PARAMS, "t_exp5": V1_TINY, "t_exp1,3": EXP_T1}[params]
    rng = np.random.default_rng(41 + nq)
    right = params.t_gsw * params.db_dim_2
    keys = sj.ExpansionKeys(params, _expansion_key_sets(params, rng, nq, cuda))
    plan = sj.ExpansionPlan(params, cuda)
    dim0 = 1 << params.db_dim_1
    pop = rng.choice(dim0, max(1, dim0 // 8), replace=False).tolist()
    for sched in (sj.dense_schedule(params, right, cuda),
                  sj.SparseExpansionPlan(params, pop, right, cuda).schedule):
        cts = residues(rng, (nq, 1, 2, 1), params).to(cuda)
        for r, rnd in enumerate(sched):
            _plant_zeros(params, cts)
            want = sj.expansion_round_plain(params, plan, r, cts, rnd, keys)
            _build.reset_launches()
            got = sj.expansion_round(params, plan, r, cts, rnd, keys)
            assert _build.LAUNCHES["expansion"] == 1
            assert torch.equal(got, want), (r, rnd.n_out)
            for c in (1, 2, 4):
                tl = sj.expansion_tiling(1, 64, c)
                assert torch.equal(sj._expansion_launch(
                    params, plan, r, cts, rnd, keys, tl), want), (r, c)
            cts = want
    torch.cuda.synchronize()


# t_conv 1 (57-bit digits, reduced before the transform) and 2 (29-bit)
R2G_T1 = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 3,'
    ' "t_conv": 1, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')
R2G_T2 = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 3, "p": 256, "q2_bits": 22, "t_gsw": 5,'
    ' "t_conv": 2, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')


def _gsw_key_sets(params, rng, nq, device):
    """_expansion_key_sets with each set's keyed conversion key."""
    from sdk_tpu_torch.ops.modops import shoup_companion_arr, u32_bits

    sets = _expansion_key_sets(params, rng, nq, device)
    for d in sets:
        m = residues(rng, (2, 2 * params.t_conv), params).numpy().astype(
            np.uint64)
        d["v_conversion"] = (u32_bits(m, device), u32_bits(
            shoup_companion_arr(params, m), device))
    return sets


@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("params", ["t_conv4", "t_conv3", "t_conv2",
                                    "t_conv1", "1gib"])
def test_regev_to_gsw_matches_plain(cuda, params, nq):
    """The regev_to_gsw kernel (a batch's folding keys and their negations
    in one launch) against regev_to_gsw_neg_plain (the A', A, B chain and
    the transform-based negation) on the card: dense leaf positions and
    scattered ones (a sparse expansion's), a query whose leaves are all
    zero (a leaf of the one query at nq = 1), q_c - 1 words planted; at the
    tiling the batch takes (a cluster of 2 blocks a leaf while the leaves
    are no more than the SMs, one block at the 1 GiB bucket's NQ = 16)."""
    from sdk_tpu_torch import poly as hpoly
    from sdk_tpu_torch.ops.modops import u32_bits
    from sdk_tpu_torch.params_store import get_params_from_store

    params = {"t_conv4": PARAMS, "t_conv3": V1_TINY, "t_conv2": R2G_T2,
              "t_conv1": R2G_T1,
              "1gib": get_params_from_store(15, 32768)}[params]
    rng = np.random.default_rng(61 + nq)
    n_gsw = params.t_gsw * params.db_dim_2
    n_leaves = 2 * n_gsw + 3
    keys = sj.ExpansionKeys(params, _gsw_key_sets(params, rng, nq, cuda))
    leaves = residues(rng, (nq, n_leaves, 2, 1), params)
    if nq > 1:
        leaves[1] = 0
    else:
        leaves[0, 3] = 0
    for c, q in enumerate(params.moduli):
        leaves[0, 1, :, :, c, :16] = q - 1
    leaves = leaves.to(cuda)
    gadget = u32_bits(hpoly.to_ntt(params, hpoly.build_gadget(
        params, 2, 2 * params.t_gsw)), cuda)
    for pos in (torch.arange(1, 2 * n_gsw, 2),
                torch.from_numpy(rng.permutation(n_leaves)[:n_gsw])):
        pos = pos.to(device=cuda, dtype=torch.int32)
        want = sj.regev_to_gsw_neg_plain(params, leaves, pos, keys, gadget)
        _build.reset_launches()
        got = sj.regev_to_gsw_neg(params, leaves, pos, keys, gadget)
        assert _build.LAUNCHES["regev_to_gsw"] == 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


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


# version-1 crypto shapes of the 1 GiB bucket (t_gsw 7, t_conv 3)
V1_TINY = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 2,'
    ' "version": 1}')
# t_exp 1 (57-bit digits, reduced before the transform) and 3
EXP_T1 = params_from_json(
    '{"n": 2, "nu_1": 3, "nu_2": 1, "p": 256, "q2_bits": 22, "t_gsw": 3,'
    ' "t_conv": 3, "t_exp_left": 1, "t_exp_right": 3, "instances": 1,'
    ' "version": 1}')
P16 = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 16, "q2_bits": 20, "t_gsw": 8,'
    ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
    ' "version": 0}')
# p = 256 with 251-byte chunks: every chunk but the first starts off a
# 4-byte boundary
P256_ODD = params_from_json(
    '{"n": 2, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,'
    ' "t_conv": 4, "t_exp_left": 8, "t_exp_right": 8, "instances": 1,'
    ' "db_item_size": 1001, "version": 0}')


FOLD_CLUSTERS = (1, 2, 4)


def _fold_every_round(params, cts, vn, vf, per_query, cuda):
    """Each round of the fold through _fold_round_launch at every tiling
    form, against fold_round_plain on the same round's input."""
    vb = 1 if per_query else 0
    dev_keys = vn.to(cuda), vf.to(cuda)
    cur = cts
    for cur_dim in range(params.db_dim_2):
        key = params.db_dim_2 - 1 - cur_dim
        sel = (slice(None),) * vb + (key,)
        want = sj.fold_round_plain(params, cur, vn[sel], vf[sel])
        slots = int(np.prod(cur.shape[:-4])) * cur.shape[-4] // 2
        dev = cur.to(cuda)
        for c in FOLD_CLUSTERS:
            tl = sj.fold_tiling(slots, params.t_gsw, c)
            got = sj._fold_round_launch(params, dev, *dev_keys, key, vb, tl)
            assert torch.equal(got.cpu(), want), (cur_dim, tl)
        cur = want


@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("params", [PARAMS, V1_TINY], ids=["t_gsw8", "t_gsw7"])
def test_fold_matches_plain(cuda, params, per_query, nq):
    """Kernel F, every round of a fold, against fold_round_plain: random
    keys, slots with a, b or both exactly zero, one key set or one per
    query; each round at every tiling form (clusters of 1, 2 and 4
    blocks)."""
    rng = np.random.default_rng(31)
    it = 2
    num_per = 1 << params.db_dim_2
    lead = (nq,) if per_query else ()
    vf = residues(rng, lead + (params.db_dim_2, 2, 2 * params.t_gsw), params)
    vn = residues(rng, lead + (params.db_dim_2, 2, 2 * params.t_gsw), params)
    cts = torch.from_numpy(rng.integers(
        0, params.modulus, (nq, it, num_per, 2, 1, params.poly_len),
        dtype=np.int64))
    cts[:, :, 0] = 0                       # a == 0
    cts[:, 0, num_per // 2 + 1] = 0        # b == 0
    if nq > 1:
        cts[1, 1, 1] = 0
        cts[1, 1, num_per // 2 + 1] = 0    # both
        cts[nq - 1, 1] = 0                 # an empty entry
    _build.reset_launches()
    got = sj.fold_ciphertexts(params, cts.to(cuda), vf.to(cuda),
                              vn.to(cuda)).cpu()
    assert _build.LAUNCHES["fold_round"] == params.db_dim_2
    assert _build.LAUNCHES["matmul_mod"] == 0
    assert torch.equal(got, sj.fold_ciphertexts(params, cts, vf, vn))
    if nq > 1:
        assert not got[nq - 1, 1].any()
    _fold_every_round(params, cts, vn, vf, per_query, cuda)


@pytest.mark.parametrize("params", [PARAMS, V1_TINY], ids=["t_gsw8", "t_gsw7"])
def test_fold_all_digits_at_maximum(cuda, params):
    """Every digit of a and b at its maximum and every key word q - 1: the
    largest 64-bit accumulators, at every tiling form."""
    bits = sj._get_bits_per(params, params.t_gsw)
    top = min((1 << (bits * params.t_gsw)) - 1, (1 << 63) - 1)
    num_per = 1 << params.db_dim_2
    cts = torch.full((2, 2, num_per, 2, 1, params.poly_len), top,
                     dtype=torch.int64)
    keys = torch.from_numpy(np.stack(
        [np.full((params.db_dim_2, 2, 2 * params.t_gsw, params.poly_len),
                 q - 1) for q in params.moduli], axis=-2).astype(np.int32))
    _fold_every_round(params, cts, keys, keys.clone(), False, cuda)


def _small(n: int, version: int, t_conv: int):
    """An n x n pack shape at a small scale (1 instance)."""
    return params_from_json(json.dumps(
        {"n": n, "nu_1": 2, "nu_2": 2, "p": 256, "q2_bits": 20, "t_gsw": 8,
         "t_conv": t_conv, "t_exp_left": 8, "t_exp_right": 8,
         "instances": 1, "version": version}))


# n = 2 versions 0 and 1; n = 4 version 0 (the parameter store's third
# shape: 5 rows, clusters of 4) and version 1 (three pairs at most fit its
# shared memory)
PACK_PARAMS = {"v0": PARAMS, "v1": V1_TINY, "n4_v0": _small(4, 0, 4),
               "n4_v1": _small(4, 1, 3)}


@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("name", list(PACK_PARAMS))
def test_pack_matches_plain(cuda, name, nq):
    """Kernel G for nq queries x instances in one launch, each query with
    its own keys, in its three output modes (NTT, raw, response words) in
    both its forms (one block, or a cluster of n blocks, a (query, instance,
    column)) at the pair count pack_tiling derives, against the plain
    versions; an all-zero scalar ct and the values 0, Q-1 and Q/2 planted."""
    params = PACK_PARAMS[name]
    rng = np.random.default_rng(32 + nq)
    nkeys = params.n if params.version == 0 else 2
    keys = [[residues(rng, (params.n + 1, params.t_conv), params)
             for _ in range(nkeys)] for _ in range(nq)]
    v_ct = torch.from_numpy(rng.integers(
        0, params.modulus, (nq, params.instances, params.n * params.n, 2, 1,
                            params.poly_len), dtype=np.int64))
    v_ct[nq // 2, 0, 1] = 0
    v_ct[0, 0, 0, :, 0, :3] = torch.tensor([0, params.modulus - 1,
                                            params.modulus // 2])
    plan_cpu = ResponseEncodePlan(params, "cpu")
    want = {"ntt": sj.pack_queries_plain(params, v_ct, keys)}
    want["raw"] = sj._from_ntt_plain(params, want["ntt"])
    want["words"] = torch.stack([plan_cpu.encode_plain(p)
                                 for p in want["raw"]])
    plan = ResponseEncodePlan(params, cuda)
    dev_keys = [[k.to(cuda) for k in ks] for ks in keys]
    v_dev = v_ct.to(cuda)
    for cluster in (1, params.n):
        for mode in sj.PACK_MODES:
            got = sj._pack_launch(params, v_dev, dev_keys, mode, plan, cluster)
            assert torch.equal(got.cpu(), want[mode]), (mode, cluster)
    _build.reset_launches()
    assert torch.equal(sj.pack_queries(params, v_dev, dev_keys).cpu(),
                       want["ntt"])
    assert torch.equal(sj.pack_queries(params, v_dev, dev_keys, raw=True)
                       .cpu(), want["raw"])
    assert torch.equal(sj.pack_encode(params, v_dev, dev_keys, plan).cpu(),
                       want["words"])
    assert _build.LAUNCHES["pack"] == 3 and _build.LAUNCHES["encode"] == 0
    assert _build.LAUNCHES["ntt_forward"] == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("params", [PARAMS, P16, P256_ODD],
                         ids=["p256", "p16", "p256_chunk251"])
@pytest.mark.parametrize("target", ["dense", "compact"])
def test_ingest_into_matches_plain(cuda, params, target):
    """Kernel H writing in place into a dense tensor and into compact
    planes, against ingest_plain + db_write_items, over an index that already
    holds other bytes; and its residue output. p = 256 with chunks of 251
    bytes reads each chunk a byte at a time, off 4-byte boundaries."""
    rng = np.random.default_rng(33)
    chunks = params.instances * params.n * params.n
    K = 7
    raw = torch.from_numpy(rng.integers(
        0, 256, (K, chunks, params.bytes_per_chunk()), dtype=np.uint8))
    raw[2] = 0
    num_per = 1 << params.db_dim_2
    shape = (sj.db_shape(params) if target == "dense"
             else sj.compact_shape(params, 8))
    ncols = 4 * shape[3]
    flat = rng.choice(num_per * ncols, K, replace=False)
    bins, cols = flat % num_per, flat // num_per
    start = torch.from_numpy(rng.integers(0, 128, shape, dtype=np.int8))
    want = start.clone()
    ingest_t.ingest_into(params, want, bins, cols, raw)
    got = start.to(cuda)
    _build.reset_launches()
    ingest_t.ingest_into(params, got, bins, cols, raw.to(cuda))
    assert _build.LAUNCHES["ingest"] == 1 and _build.LAUNCHES["ntt_forward"] == 0
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ingest_items_device(params, raw.to(cuda)).cpu(),
                       ingest_t.ingest_plain(params, raw))
    with pytest.raises(ValueError):
        ingest_t.ingest_into(params, got, bins + num_per, cols, raw.to(cuda))


# 64 bins a row (32-byte sectors, as the 1 GiB bucket), 128 columns, 8,192
# items
WIDE = params_from_json(
    '{"n": 2, "nu_1": 7, "nu_2": 6, "p": 256, "q2_bits": 22, "t_gsw": 7,'
    ' "t_conv": 3, "t_exp_left": 5, "t_exp_right": 5, "instances": 1,'
    ' "version": 1}')


@pytest.mark.parametrize("case", ["neighbouring_1024", "scattered",
                                  "partial_groups", "group_split"])
def test_ingest_into_sector_cases(cuda, case):
    """Kernel H's sector writer over a prefilled dense index of 32-byte
    sectors, against ingest_plain + db_write_items, one launch a flush
    chunk: a bulk load's 1,024 neighbouring items (whole sectors), scattered
    items (a sector each, read-modify-write), groups with holes beside
    whole ones and a group split across two launches. 1,024 items are
    several transform / writer pairs in one launch."""
    params = WIDE
    rng = np.random.default_rng(60)
    chunks = params.instances * params.n * params.n
    n = params.num_items()
    idxs = {"neighbouring_1024": np.arange(1024, 2048),
            "scattered": np.sort(rng.choice(n, 256, replace=False)),
            "partial_groups": np.sort(np.r_[np.arange(512, 640),
                                            rng.choice(512, 100, replace=False)]),
            "group_split": np.arange(8, 200)}[case]
    K = len(idxs)
    raw = torch.from_numpy(rng.integers(
        0, 256, (K, chunks, params.bytes_per_chunk()), dtype=np.uint8))
    num_per = 1 << params.db_dim_2
    bins, cols = idxs % num_per, idxs // num_per
    start = torch.from_numpy(rng.integers(0, 128, sj.db_shape(params),
                                          dtype=np.int8)).to(cuda)
    want = start.clone()
    sj.db_write_items(params, want, bins, cols,
                      ingest_t.ingest_plain(params, raw.to(cuda)))
    got = start
    dev_raw = raw.to(cuda)
    splits = {"group_split": (0, 21, K)}.get(case, (0, K))
    _build.reset_launches()
    for s, e in zip(splits[:-1], splits[1:]):
        ingest_t.ingest_into(params, got, bins[s:e], cols[s:e], dev_raw[s:e])
    assert _build.LAUNCHES["ingest"] == len(splits) - 1
    assert torch.equal(got, want)
    torch.cuda.synchronize()


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
                                       "regev_to_gsw", "scan", "pack",
                                       "expansion")), counts
    assert counts["expansion"] == params.g() and counts["expand_round"] == 0
    assert counts["regev_to_gsw"] == 1 and counts["matmul_mod"] == 0, counts
    assert counts["pack"] == 1 and counts["encode"] == 0, counts


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
    assert counts["expansion"] == params.g(), counts
    # S3 migrates on the read's flush, through kernel H'
    assert counts["compact_to_dense"] == (state == "S3"), counts


def test_batched_engine_on_card_equals_cpu(cuda):
    """A 3-query batch (padded to 4 for the scan) from two sessions through
    the bucket on the card equals the CPU plain engine byte for byte, and
    goes through E, F and G once per round and batch (G encoding the
    responses: no launch of D)."""
    params = PARAMS
    rng = np.random.default_rng(12)
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    items = list(range(0, 200, 5))
    sessions = [_session(params, 0x51), _session(params, 0x61)]
    blobs = None
    responses = []
    for device in (cuda, "cpu"):
        srv = SpiralKvServerTorch(params, device)
        for i in items:
            srv.update_item_raw(i, np.random.default_rng(i).integers(
                0, 256, row_len, dtype=np.uint8).tobytes())
        uids = [srv.setup_raw(pp.serialize(params), f"{k}" * 36)
                for k, (_, pp) in enumerate(sessions)]
        if blobs is None:
            blobs = [uids[k % 2].encode() + sessions[k % 2][0].generate_query(
                items[3 + k], noise_rng=ChaCha20Rng(bytes([0x70 + k]) * 32),
                query_seed=bytes([0x80 + k]) * 32).serialize(params)
                for k in range(3)]
        srv.flush()
        _build.reset_launches()
        responses.append(srv.private_read_blobs(blobs))
        if device is cuda:
            counts = dict(_build.LAUNCHES)
    assert responses[0] == responses[1]
    assert counts["fold_round"] == params.db_dim_2 and counts["pack"] == 1
    assert counts["encode"] == 0 and counts["scan"] == 1, counts
    assert counts["expansion"] == params.g(), counts     # a round, not a query
    assert counts["regev_to_gsw"] == 1, counts            # a batch
    for k in range(3):
        row = np.random.default_rng(items[3 + k]).integers(
            0, 256, row_len, dtype=np.uint8).tobytes()
        assert sessions[k % 2][0].decode_response(responses[0][k])[:row_len] == row


DIRECT_SMALL = params_from_json(
    '{"direct_upload": 1, "n": 2, "nu_1": 4, "nu_2": 2, "p": 256,'
    ' "q2_bits": 20, "t_gsw": 8, "t_conv": 4, "t_exp_left": 8,'
    ' "t_exp_right": 8}')


def test_direct_upload_read_and_batch_on_card_equal_cpu(cuda):
    """Direct-upload requests (the public params inline, no expansion)
    through a bucket on the card and one on the CPU fed the same rows: a
    single read and a 3-query batch give the same bytes, decode, and launch
    A once (the GSW keys), the scan, A' (the fold input), one F a round and
    one G, with no expansion and no regev_to_gsw kernel."""
    params = DIRECT_SMALL
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    items = [3, 17, 40, 63]
    sessions = [_session(params, 0x81 + 4 * k) for k in range(3)]
    blobs = [pp.serialize(params) + c.generate_query(
        items[k], noise_rng=ChaCha20Rng(bytes([0x90 + k]) * 32),
        query_seed=bytes([0xA0 + k]) * 32).serialize(params)
        for k, (c, pp) in enumerate(sessions)]
    responses, counts = [], []
    for device in (cuda, "cpu"):
        srv = SpiralKvServerTorch(params, device)
        for i in items:
            srv.update_item_raw(i, np.random.default_rng(i).integers(
                0, 256, row_len, dtype=np.uint8).tobytes())
        srv.flush()
        _build.reset_launches()
        single = srv.private_read_one(blobs[0])
        one = dict(_build.LAUNCHES)
        _build.reset_launches()
        responses.append([single] + srv.private_read_blobs(blobs))
        counts.append((one, dict(_build.LAUNCHES)))
    assert responses[0] == responses[1]
    want = {"ntt_forward": 1, "scan_compact": 1, "ntt_inverse": 1,
            "fold_round": params.db_dim_2, "pack": 1}
    for c in counts[0]:
        assert {k: v for k, v in c.items() if v} == want, c
    for k, resp in enumerate(responses[0][1:]):
        row = np.random.default_rng(items[k]).integers(
            0, 256, row_len, dtype=np.uint8).tobytes()
        assert sessions[k][0].decode_response(resp)[:row_len] == row


def test_client_test_hook_on_card(cuda):
    """CLIENT_TEST on the card: the right target passes and the response
    is the one without the hook; a wrong target raises ClientTestFailure
    before G is launched."""
    from sdk_tpu_torch import debug_hooks

    params = PARAMS
    params_h = params_j.params_from_json(json.dumps(params_to_json_obj(params)))
    client, pp = _session(params, 0x91)
    query = client.generate_query(
        11, noise_rng=ChaCha20Rng(b"\x94" * 32), query_seed=b"\x95" * 32)
    item, db = server_host.generate_random_db_and_get_item(params_h, 11)
    srv = SpiralServerTorch(params, cuda)
    srv.set_db_host_tensor(db)
    plain = srv.process_query(pp, query)
    try:
        debug_hooks.set_client_test(client.sk_reg, item[0, 0])
        _build.reset_launches()
        assert srv.process_query(pp, query) == plain
        assert _build.LAUNCHES["pack"] == 1
        debug_hooks.set_client_test(
            client.sk_reg, (item[0, 0] + 1) % np.uint64(params.pt_modulus))
        _build.reset_launches()
        with pytest.raises(debug_hooks.ClientTestFailure):
            srv.process_query(pp, query)
        assert _build.LAUNCHES["pack"] == 0
        assert _build.LAUNCHES["fold_round"] == params.db_dim_2
    finally:
        debug_hooks.clear_client_test()


# ---- DoublePIR: kernels K (dp_dot_i8) and L (dp_matmul_u32) ---------------

def _u32(rng, shape, bits=32):
    return torch.from_numpy(rng.integers(0, 1 << bits, shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("shape", [(4, 1000, 300), (3, 70001, 8), (64, 300, 7),
                                   (300, 257, 1), (70, 1234, 130), (1, 1, 1)])
def test_dp_matmul_u32_matches_plain(cuda, shape):
    from sdk_tpu_torch.doublepir import kernels as dk

    M, K, N = shape
    rng = np.random.default_rng(11)
    a, b = _u32(rng, (M, K)), _u32(rng, (K, N))
    before = _build.LAUNCHES["dp_matmul_u32"]
    got = dk.matmul_u32(a.to(cuda), b.to(cuda)).cpu()
    assert _build.LAUNCHES["dp_matmul_u32"] == before + 1
    assert torch.equal(got, dk.matmul_u32_plain(a, b))


@pytest.mark.parametrize("shape", [(4, 333, 300), (4, 30001, 8), (300, 11, 1),
                                   (70, 100, 130)])
def test_dp_matmul_u32_packed_matches_plain(cuda, shape):
    from sdk_tpu_torch.doublepir import kernels as dk

    M, cols, N = shape
    rng = np.random.default_rng(12)
    ap, b = _u32(rng, (M, cols), bits=30), _u32(rng, (cols * 3, N))
    want = dk.matmul_u32_packed_plain(ap, b)
    assert torch.equal(dk.mat_mul_vec_packed(ap.to(cuda), b.to(cuda)).cpu(),
                       want)
    bt = b.t().contiguous()
    assert torch.equal(
        dk.mat_mul_transposed_packed(ap.to(cuda), bt.to(cuda)).cpu(), want)


@pytest.mark.parametrize("shape", [(4, 92682, 1024, 8), (4, 92682, 1024, 1),
                                   (4, 3003, 64, 3), (8, 999, 1024, 256),
                                   (1, 3, 4, 1), (3, 30003, 7, 5),
                                   (5, 6147, 2050, 9), (6, 30000, 2048, 4),
                                   (4, 9000, 1024, 8, "unaligned"),
                                   (9, 999, 64, 8), (4, 999, 64, 257)])
def test_dp_answer_products_match_plain(cuda, shape):
    """L's answer form (msg0 and h_2 of one packed operand in one launch)
    against the two plain packed products on the card: the production
    checklist's shapes (K = 92682, A2 1024 columns, nq 8 and 1), rows of
    K / 3 words, N0 not a multiple of 4, N0 past one pass of 1024 columns,
    b1 at its 256-column limit, and a b0 off a 16-byte boundary (4-byte
    copies); past the form's 8 rows or 256 b1 columns, two
    mat_mul_vec_packed launches."""
    from sdk_tpu_torch.doublepir import kernels as dk

    M, K, N0, N1 = shape[:4]
    rng = np.random.default_rng(13)
    ap = _u32(rng, (M, K // 3), bits=30).to(cuda)
    b0 = _u32(rng, (K, N0)).to(cuda)
    if len(shape) > 4:
        flat = torch.empty(K * N0 + 1, dtype=torch.int32, device=cuda)
        flat[1:] = b0.flatten()
        b0 = flat[1:].view(K, N0)
        assert b0.data_ptr() % 16
    b1 = _u32(rng, (K, N1)).to(cuda)
    want = dk.answer_products_plain(ap, b0, b1)
    _build.reset_launches()
    got = dk.answer_products(ap, b0, b1)
    one = M <= dk.ANSWER_MAX_ROWS and N1 <= dk.ANSWER_MAX_N1
    assert _build.LAUNCHES["dp_matmul_u32"] == (1 if one else 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("shape", [(37, 1001, 1), (37, 1003, 3), (9, 4098, 8),
                                   (200, 777, 40), (130, 64, 130),
                                   (1, 5, 2), (131, 1003, 136),
                                   (257, 4099, 1024)])
def test_dp_dot_i8_matches_plain(cuda, shape, pair):
    from sdk_tpu_torch.doublepir import server_torch as st

    M, K, N = shape
    rng = np.random.default_rng(13)
    b = _u32(rng, (K, N))
    if pair:
        lo = torch.from_numpy(rng.integers(0, 128, (M, K)).astype(np.int8))
        hi = torch.from_numpy(rng.integers(0, 4, (M, K)).astype(np.int8))
        got = st.dot_i8pair_u32(lo.to(cuda), hi.to(cuda), b.to(cuda), c=-232)
        want = st.dot_i8pair_u32(lo, hi, b, c=-232)
    else:
        a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
        got = st.dot_i8_u32(a.to(cuda), b.to(cuda), c=128 - 232)
        want = st.dot_i8_u32(a, b, c=128 - 232)
    assert torch.equal(got.cpu(), want)


def _dot_operands(rng, M, K, N, pair, form):
    """(a planes, b) on the CPU: the worst values of the tiled form's s32
    runs (a = -128, b = 0xFFFFFFFF; the pair form's a_lo = 127 with a_hi 2,
    3 and 1 in turn, a' = 127 with x = 1 at a_hi = 2), or random ones."""
    if form == "worst":
        b = torch.full((K, N), -1, dtype=torch.int32)
        if pair:
            hi = torch.tensor([2, 3, 1], dtype=torch.int8).repeat(-(-M // 3))
            return [torch.full((M, K), 127, dtype=torch.int8),
                    hi[:M, None].expand(M, K).contiguous()], b
        return [torch.full((M, K), -128, dtype=torch.int8)], b
    b = _u32(rng, (K, N))
    if pair:
        return [torch.from_numpy(rng.integers(0, 128, (M, K)).astype(np.int8)),
                torch.from_numpy(rng.integers(0, 4, (M, K)).astype(np.int8))], b
    return [torch.from_numpy(rng.integers(-128, 128, (M, K))
                             .astype(np.int8))], b


@pytest.mark.parametrize("form", ["worst", "random"])
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("K", [65800, 92683])
def test_dp_dot_i8_tiled_past_one_run(cuda, K, pair, form):
    """The tiled form past one s32 run of 65,536 k (its accumulators
    restart) and past the JAX program's 128 * 127 * K < 2^31, at the worst
    values, in aligned rows of the card."""
    from sdk_tpu_torch.doublepir import server_torch as st

    M, N = 37, 24
    planes, b = _dot_operands(np.random.default_rng(15), M, K, N, pair, form)
    dev = []
    for pl in planes:
        rows = st.aligned_rows(M, K, cuda)
        rows.copy_(pl.to(cuda))
        dev.append(rows)
    c = -232 if pair else 128 - 232
    b_dev = b.to(cuda)
    got = st._dot(dev[0], dev[1] if pair else None, b_dev, c, False)
    want = st._dot_plain(dev[0], dev[1] if pair else None, b_dev, c, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pair", [False, True])
def test_dp_dot_i8_tiled_production_rows(cuda, pair):
    """256 rows at the production checklist's widths: DB rows (m = 92,683)
    @ A1 (n = 1,024), or digit rows (l = 92,681) @ A2, with the setup's add
    rows."""
    from sdk_tpu_torch.doublepir import server_torch as st

    M, K, N = (256, 92681, 1024) if pair else (256, 92683, 1024)
    planes, b = _dot_operands(np.random.default_rng(16), M, K, N, pair,
                              "random")
    dev = []
    for pl in planes:
        rows = st.aligned_rows(M, K, cuda)
        rows.copy_(pl.to(cuda))
        dev.append(rows)
    c = -232 if pair else 128 - 232
    b_dev = b.to(cuda)
    got = st._dot(dev[0], dev[1] if pair else None, b_dev, c, False)
    want = st._dot_plain(dev[0], dev[1] if pair else None, b_dev, c, False)
    assert torch.equal(got, want)


def _card_rows(planes, cuda):
    """CPU int8 planes copied into kernel K's aligned rows on the card."""
    from sdk_tpu_torch.doublepir import server_torch as st

    out = []
    for pl in planes:
        rows = st.aligned_rows(pl.shape[0], pl.shape[1], cuda)
        rows.copy_(pl.to(cuda))
        out.append(rows)
    return out


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("N", range(1, 9))
def test_dp_dot_i8_narrow_ragged(cuda, N, pair):
    """The narrow form (N <= 8) in one launch against its plain version:
    300 rows (two row groups, not a multiple of 16), K = 4,099 (not a
    multiple of 32), every N, with the setup's add rows; and a b off a
    16-byte boundary (word copies of its slices)."""
    from sdk_tpu_torch.doublepir import server_torch as st

    M, K = 300, 4099
    planes, b = _dot_operands(np.random.default_rng(20 + N), M, K, N, pair,
                              "random")
    dev = _card_rows(planes, cuda)
    c = -232 if pair else 128 - 232
    b_dev = b.to(cuda)
    if N % 4 == 0:
        flat = torch.empty(K * N + 1, dtype=torch.int32, device=cuda)
        flat[1:] = b_dev.flatten()
        b_dev = flat[1:].view(K, N)
    _build.reset_launches()
    got = st._dot(dev[0], dev[1] if pair else None, b_dev, c, False)
    assert _build.LAUNCHES["dp_dot_i8"] == 1
    want = st._dot_plain(dev[0], dev[1] if pair else None, b_dev, c, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [8, 1])
def test_dp_dot_i8_narrow_production_a2(cuda, nq):
    """The answer's a_2 at the production shape, (4,096 x 92,682) digit
    planes @ q2 (92,682 x nq), held against the plain version on its first,
    middle and last 256 rows."""
    from sdk_tpu_torch.doublepir import server_torch as st

    rows, l3 = 4096, 92682
    gen = torch.Generator(device=cuda).manual_seed(21)
    lo, hi = st.aligned_rows(rows, l3, cuda), st.aligned_rows(rows, l3, cuda)
    lo.copy_(torch.randint(0, 128, (rows, l3), dtype=torch.int8, device=cuda,
                           generator=gen))
    hi.copy_(torch.randint(0, 4, (rows, l3), dtype=torch.int8, device=cuda,
                           generator=gen))
    q2 = torch.randint(-(1 << 31), 1 << 31, (l3, nq), dtype=torch.int64,
                       device=cuda, generator=gen).to(torch.int32)
    _build.reset_launches()
    got = st.dot_i8pair_u32(lo, hi, q2)
    assert _build.LAUNCHES["dp_dot_i8"] == 1
    for sl in (slice(0, 256), slice(1920, 2176), slice(rows - 256, rows)):
        assert torch.equal(got[sl], st._dot_plain(lo[sl], hi[sl], q2, 0,
                                                  False))


@pytest.mark.parametrize("form", ["worst", "random"])
@pytest.mark.parametrize("pair", [False, True])
def test_dp_dot_i8_narrow_past_one_run(cuda, pair, form):
    """K = 131,000 over 133 row groups: the grid takes two splits, the first
    a whole run of 65,536 k, past the JAX program's bound; at the worst
    values (b = 0xFFFFFFFF; a = -128, or the pair's (a_lo, a_hi) = (127,
    2), (127, 3), (0, 1), (127, 0) by row) each run stays inside int32
    only because no split is longer. Checked on the first and last rows."""
    from sdk_tpu_torch.doublepir import server_torch as st

    M, K, N = 133 * 256, 131000, 8
    gen = torch.Generator(device=cuda).manual_seed(22)
    if form == "worst":
        b = torch.full((K, N), -1, dtype=torch.int32, device=cuda)
        if pair:
            lo_hi = torch.tensor([[127, 2], [127, 3], [0, 1], [127, 0]],
                                 dtype=torch.int8, device=cuda)
            by_row = lo_hi[torch.arange(M, device=cuda) % 4]
            fills = [by_row[:, :1], by_row[:, 1:]]
        else:
            fills = [torch.full((M, 1), -128, dtype=torch.int8, device=cuda)]
        planes = []
        for f in fills:
            rows = st.aligned_rows(M, K, cuda)
            rows.copy_(f.expand(M, K))
            planes.append(rows)
    else:
        b = torch.randint(-(1 << 31), 1 << 31, (K, N), dtype=torch.int64,
                          device=cuda, generator=gen).to(torch.int32)
        bounds = [(0, 128), (0, 4)] if pair else [(-128, 128)]
        planes = []
        for low, high in bounds:
            rows = st.aligned_rows(M, K, cuda)
            rows.copy_(torch.randint(low, high, (M, K), dtype=torch.int8,
                                     device=cuda, generator=gen))
            planes.append(rows)
    hi = planes[1] if pair else None
    c = -232 if pair else 128 - 232
    got = st._dot(planes[0], hi, b, c, False)
    for sl in (slice(0, 64), slice(M - 64, M)):
        want = st._dot_plain(planes[0][sl], None if hi is None else hi[sl],
                             b, c, False)
        assert torch.equal(got[sl], want)
    del planes, hi
    torch.cuda.empty_cache()


def test_mma_s32_accumulation_wraps(cuda):
    """mma.sync's s32 accumulation past 2^31 (the probe in dp_dot_i8.cu:
    3,000 products of 1,036,320 into accumulators that never restart)
    wraps mod 2^32. Kernel K does not rely on it: its runs stay inside
    int32 (tests/test_torch_dot_i8_tiling.py)."""
    steps = 3000
    out = torch.empty((32, 4), dtype=torch.int32, device=cuda)
    rc = _build.lib()["sdk_dp_mma_wrap_probe"](
        out.data_ptr(), steps, _build.stream_of(out))
    assert rc == 0
    torch.cuda.synchronize()
    total = steps * 32 * 127 * 255
    wrapped = (total + (1 << 31)) % (1 << 32) - (1 << 31)
    assert total >= 1 << 31
    assert torch.equal(out.cpu(), torch.full((32, 4), wrapped,
                                             dtype=torch.int32))


@pytest.mark.parametrize("K", [1003, 1004])
@pytest.mark.parametrize("nq", [1, 3, 4, 8])
def test_dp_dot_i8_select_matches_plain(cuda, nq, K):
    """K = 1003 in aligned rows with a ragged last word; K = 1004
    contiguous, read in place."""
    from sdk_tpu_torch.doublepir import server_torch as st

    rng = np.random.default_rng(14)
    M = 101
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    b = _u32(rng, (K, nq))
    if K % 4:
        a_dev = st.aligned_rows(M, K, cuda)
        a_dev.copy_(a)
    else:
        a_dev = a.to(cuda)
        assert st._kernel_rows(a_dev) is a_dev
    got = st.dot_i8_select(a_dev, b.to(cuda), c=128).cpu()
    assert torch.equal(got, st.dot_i8_select(a, b, c=128))
    full = st.dot_i8_u32(a, b, c=128)
    idx = st.batch_index(M, nq, "cpu")
    assert torch.equal(got, full[torch.arange(M), idx])


@pytest.mark.parametrize("config", ["64,6.4,13,17,32,464",
                                    "64,6.4,200,301,32,464"])
def test_checklist_on_card_equals_cpu(cuda, config):
    """Hint, squished H1 and every answer matrix of the checklist server on
    the card equal the CPU plain versions'; the answers launch K and L."""
    from sdk_tpu_torch.doublepir import scheme
    from sdk_tpu_torch.doublepir.params import Params
    from sdk_tpu_torch.doublepir.server_torch import ChecklistServerTorch

    params = Params.from_string(config)
    num_entries = params.l * params.m * 8 - 5
    rng = np.random.default_rng(15)
    bits = rng.integers(0, 256, (num_entries + 7) // 8,
                        dtype=np.uint16).astype(np.uint8)
    servers = [ChecklistServerTorch(num_entries, params, bits, device=d)
               for d in (cuda, "cpu")]
    hints = [s.setup_streamed() for s in servers]
    np.testing.assert_array_equal(hints[0][0], hints[1][0])
    np.testing.assert_array_equal(servers[0].h1_sq, servers[1].h1_sq)
    shared = scheme.init(servers[0].info, params)
    for nq in (1, 4, 8):
        queries = [scheme.query(int(t), shared, params, servers[0].info,
                                rng)[1]
                   for t in rng.integers(0, num_entries, nq)]
        _build.reset_launches()
        got = servers[0].answer(queries)
        assert _build.LAUNCHES["dp_dot_i8"] == 2
        assert _build.LAUNCHES["dp_matmul_u32"] == 1   # msg0 and h_2 in one
        for g, w in zip(got, servers[1].answer(queries)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("form", ["spiral", "wrapping", "unaligned"])
@pytest.mark.parametrize("D", [1, 2, 4, 8, 64])
def test_psum_mod_matches_plain(cuda, D, form):
    """Kernel M against its plain version in one launch: the Spiral form
    (two channels, each mod its own q), the wrapping form (q = 0) at an odd
    size, and parts off 16-byte boundaries (the one-element path); one part
    and the 64 the kernel's parameters hold."""
    from sdk_tpu_torch.ops import shard

    rng = np.random.default_rng(30 + D)
    if form == "spiral":
        # (crt, 4, 6, z): channel c below q_c
        parts = [residues(rng, (4, 6)).permute(2, 0, 1, 3).contiguous()
                 for _ in range(D)]
        q = PARAMS.moduli
    else:
        n = 1001 if form == "wrapping" else 4096
        parts = [torch.from_numpy(rng.integers(
            0, 1 << 32, n + 1, dtype=np.uint64).astype(np.uint32)
            .view(np.int32)) for _ in range(D)]
        parts = [p[:n] if form == "wrapping" else p[1:] for p in parts]
        q = 0
    want = shard.psum_mod_plain(parts, q)
    _build.reset_launches()
    got = shard.psum_mod([p.to(cuda) for p in parts], q)
    assert _build.LAUNCHES["psum_mod"] == 1
    assert torch.equal(got.cpu(), want)


def _random_compact(params, cap, gen, cuda):
    """A compact index of random bytes on the card: every bin's cap slots
    on distinct random dim0 columns, its first counts[b] occupied (random
    counts, bin 0 full with slot 0 on column 0)."""
    planes = torch.randint(-128, 128, sj.compact_shape(params, cap),
                           dtype=torch.int8, device=cuda, generator=gen)
    npr, dim0 = 1 << params.db_dim_2, 1 << params.db_dim_1
    idx_j = torch.stack([torch.randperm(dim0, device=cuda, generator=gen)[:cap]
                         for _ in range(npr)]).to(torch.int32)
    at = (idx_j[0] == 0).nonzero().flatten()      # column 0 to slot 0
    if len(at):
        idx_j[0, at[0]] = idx_j[0, 0].clone()
    idx_j[0, 0] = 0
    counts = torch.randint(0, cap + 1, (npr,), generator=gen,
                           device=cuda).cpu().numpy()
    counts[0] = cap
    return sj.CompactDb(planes, idx_j), counts


@pytest.mark.parametrize("cap", [4, 8, 64, 128])
def test_compact_to_dense_matches_plain(cuda, cap):
    """Kernel H' against its plain version on a compact index whose bin 0
    holds an item at dim0 column 0 (the idx_j every unoccupied slot carries)
    and whose unoccupied slots hold random bytes and random idx_j: only the
    occupied slots s < counts[b] are placed. Caps 4 and 8 at the fast
    params (4 bins a row); caps 64 (the fill's) and 128 (the S2 state's)
    over 64 bins a row, random slots."""
    if cap >= 64:
        params = WIDE
        gen = torch.Generator(device=cuda).manual_seed(40 + cap)
        db, counts = _random_compact(params, cap, gen, cuda)
        want = ingest_t.compact_to_dense_plain(params, db, counts)
        assert want[:, :, :, 0, :, :, 0, 0].any()
        _build.reset_launches()
        got = ingest_t.compact_to_dense(params, db, counts)
        assert _build.LAUNCHES["compact_to_dense"] == 1
        assert torch.equal(got, want)
        return
    params = PARAMS
    rng = np.random.default_rng(40 + cap)
    row_len = params.instances * params.n * params.n * params.bytes_per_chunk()
    buf = ingest_t.DbUpdateBuffer(params, "cpu")
    for i in (0, 4, 9, 17, 255):
        buf.upsert_raw(i, rng.integers(0, 256, row_len, dtype=np.uint8)
                       .tobytes())
    db = buf.flush(sj.compact_db_empty(params, "cpu", cap_bin=cap))
    counts = buf.slots.bin_count.copy()
    planes, idx_j = db.planes.clone(), db.idx_j.clone()
    for b in range(idx_j.shape[0]):
        for s in range(int(counts[b]), cap):
            planes[:, :, :, s // 4, :, :, b, s % 4] = torch.from_numpy(
                rng.integers(1, 128, planes.shape[:3] + planes.shape[4:6],
                             dtype=np.int8))
            idx_j[b, s] = int(rng.integers(0, 1 << params.db_dim_1))
    want = ingest_t.compact_to_dense_plain(params, sj.CompactDb(planes, idx_j),
                                           counts)
    assert want[:, :, :, 0, :, :, 0, 0].any()
    _build.reset_launches()
    got = ingest_t.compact_to_dense(
        params, sj.CompactDb(planes.to(cuda), idx_j.to(cuda)), counts)
    assert _build.LAUNCHES["compact_to_dense"] == 1
    assert torch.equal(got.cpu(), want)


def test_sharded_serving_on_card(cuda):
    """The two selfchecks over logical meshes of the card: sharded Spiral
    and checklist responses equal unsharded serving and decode; the sums go
    through kernel M."""
    from sdk_tpu_torch.ops.shard import make_mesh
    from sdk_tpu_torch.selfcheck import (sharded_doublepir_check,
                                         sharded_protocol_check)

    _build.reset_launches()
    sharded_protocol_check(make_mesh(8, dp=2, devices=[cuda] * 8))
    sharded_doublepir_check(make_mesh(4, devices=[cuda] * 4))
    assert _build.LAUNCHES["psum_mod"] > 0
