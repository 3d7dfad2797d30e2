"""Kernel M's reduction (csrc/psum_mod.cu) modelled in torch int64 with the
constants the host works out for it (ops/shard.reduction_constants): an
element's sum hi * 2^32 + lo (hi < D <= 64) becomes t = hi * (2^32 mod q)
+ lo, less a Barrett quotient __umul64hi(t, floor((2^64 - 1) / q)) times
q, then one conditional subtraction (q = 0 keeps lo).

The model (reduce_sum below) is held against the plain version
(psum_mod_plain, whose `%` it replaces) and, through shard_map on the 8
virtual CPU devices, against the JAX package's psum_mod, at D = 1, 2, 4, 8
and 64, both Spiral moduli and q = 0, with every part at q - 1 or
0xFFFFFFFF. Integer results: the tolerance is 0. The kernel itself runs
only on the card (tests/test_torch_kernels_gpu.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sdk_tpu.ops import shard as shard_j
from sdk_tpu_torch.ops import shard
from sdk_tpu_torch.params import get_fast_expansion_testing_params

torch.set_num_threads(1)
MODULI = get_fast_expansion_testing_params().moduli
M32 = 0xFFFFFFFF


def _mulhi64(t: torch.Tensor, m: int) -> torch.Tensor:
    """__umul64hi(t, m) for int64 t in [0, 2^63) and 0 <= m < 2^64: the
    high 64 bits of the 128-bit product, by 16-bit limbs in int64 (the
    column sums stay below 2^35); the result must lie below 2^63."""
    tl = [(t >> (16 * i)) & 0xFFFF for i in range(4)]
    ml = [(m >> (16 * i)) & 0xFFFF for i in range(4)]
    carry = torch.zeros_like(t)
    hi = torch.zeros_like(t)
    for col in range(8):
        s = carry + sum(tl[i] * ml[col - i] for i in range(4)
                        if 0 <= col - i < 4)
        if col >= 4:
            hi = hi | ((s & 0xFFFF) << (16 * (col - 4)))
        carry = s >> 16
    return hi


def reduce_sum(acc: torch.Tensor, q: int) -> torch.Tensor:
    """Kernel M's reduction of int64 sums ``acc`` = hi * 2^32 + lo (hi <
    64) mod q with reduction_constants(q), step by step as the kernel runs
    it: t = hi * r + lo, s = t - __umul64hi(t, m) * q, one conditional
    subtraction (q = 0: lo); psum_mod_plain reduces with ``%``."""
    q, r, m = shard.reduction_constants(q)
    lo = acc & M32
    if q == 0:
        return lo
    t = (acc >> 32) * r + lo
    s = t - _mulhi64(t, m) * q
    return torch.where(s >= q, s - q, s)


def kernel_sum(parts, q) -> torch.Tensor:
    """The kernel's sum of one channel: the D uint32 values added in a
    uint64, then reduce_sum; int32 bit patterns, as the kernel stores."""
    acc = sum(p.to(torch.int64) & M32 for p in parts)
    r = reduce_sum(acc, q)
    return (((r + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)


def parts_of(D: int, q: int, fill: str, n: int = 512) -> list:
    """D parts of n words: every word at q - 1 (0xFFFFFFFF for q = 0), or
    random below q (any 32 bits for q = 0) with the first and last words
    at the top."""
    top = M32 if q == 0 else q - 1
    rng = np.random.default_rng(D + q % 97)
    if fill == "top":
        x = np.full((D, n), top, np.uint64)
    else:
        x = rng.integers(0, top + 1, (D, n), dtype=np.uint64)
        x[:, 0] = x[:, -1] = top
    return [torch.from_numpy(r.astype(np.uint32).view(np.int32)) for r in x]


def test_constants():
    """r = 2^32 mod q and m = floor((2^64 - 1) / q) for each channel;
    zeros for the wrapping form; a modulus past 32 bits is refused."""
    for q in MODULI:
        assert shard.reduction_constants(q) == (q, (1 << 32) % q,
                                                ((1 << 64) - 1) // q)
    assert shard.reduction_constants(0) == (0, 0, 0)
    with pytest.raises(ValueError):
        shard.reduction_constants(1 << 32)


@pytest.mark.parametrize("fill", ["top", "random"])
@pytest.mark.parametrize("q", list(MODULI) + [0], ids=lambda q: f"q{q}")
@pytest.mark.parametrize("D", [1, 2, 4, 8, 64])
def test_reduction_matches_plain(D, q, fill):
    """The kernel's hi / lo reduction equals psum_mod_plain's `%`."""
    parts = parts_of(D, q, fill)
    assert torch.equal(kernel_sum(parts, q), shard.psum_mod_plain(parts, q))


def test_two_channels_at_the_top():
    """The Spiral form's two channels, each reduced with its own constants
    (axis 0), every part at q_c - 1, D = 64."""
    D = 64
    parts = [torch.stack([torch.full((300,), q - 1, dtype=torch.int64)
                          for q in MODULI]).to(torch.int32) for _ in range(D)]
    want = shard.psum_mod_plain(parts, MODULI)
    got = torch.stack([kernel_sum([p[c] for p in parts], q)
                       for c, q in enumerate(MODULI)])
    assert torch.equal(got, want)
    for c, q in enumerate(MODULI):
        assert int(got[c, 0]) == D * (q - 1) % q


@pytest.mark.parametrize("fill", ["top", "random"])
@pytest.mark.parametrize("q", MODULI, ids=lambda q: f"q{q}")
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_reduction_matches_jax(D, q, fill):
    """JAX's psum_mod (16-bit halves through lax.psum, a Shoup recombine)
    under shard_map on D of the 8 virtual CPU devices, against the
    kernel's reduction of the same parts."""
    parts = parts_of(D, q, fill, n=256)
    x = np.stack([p.numpy().view(np.uint32) for p in parts])
    mesh_j = shard_j.make_mesh(D, dp=1)

    @functools.partial(shard_j.shard_map, mesh=mesh_j,
                       in_specs=P(("dp", "db"), None),
                       out_specs=P(("dp", "db"), None), check_rep=False)
    def f(s):
        return shard_j.psum_mod(s, q, "db")

    want = np.asarray(jax.jit(f)(jnp.asarray(x)))[0]
    np.testing.assert_array_equal(kernel_sum(parts, q).numpy().view(np.uint32),
                                  want)
