"""Negacyclic NTT over the CRT channels: kernel group A.

``ntt_forward`` / ``ntt_inverse`` take int32 residues ``(..., crt, n)`` and
return canonical int32 residues in [0, q_c), word-identical to
sdk_tpu/ops/ntt_jax.py and the host oracle sdk_tpu/ntt_host.py. A CUDA
tensor runs the hand-written kernel (csrc/ntt.cu); a CPU tensor runs the
plain version beside it.

The kernel (and kernel F, csrc/fold_round.cu) runs on the transform core of
csrc/ntt_device.cuh: 128 threads a 2048-point polynomial, 16 coefficients a
thread, three passes of butterflies in registers with two exchanges through
a padded shared buffer. :data:`CORE_PASSES`, :func:`core_index`,
:func:`core_pad` and :func:`core_twiddle` give its index maps and twiddle
indices as the CUDA code computes them; tests/test_torch_ntt_fold_schedule.py
emulates the passes with them.

The forward transform takes any uint32 bit pattern and returns the exact
transform of the input mod q_c: the plain version reduces every input first,
the kernel's lazy Harvey butterflies take [0, 4q_c) and reduce what lies
above as they load it. (The JAX function is the same on [0, 4q_c); above
that it runs its lazy butterflies unreduced and returns words that are not
canonical, tests/test_ntt_jax.py:48 pins them against its host oracle only.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params

from .. import _build
from .modops import moduli_column, u32_bits

_TABLES: dict = {}

CORE_LOG_N = 11                 # the core's polynomials: n = 2048
CORE_GROUP = 128                # threads a polynomial
CORE_PER = 16                   # coefficients a thread
# (layout, stages S, t_lo) of the forward passes, strides t_lo * 2^(S-1)
# down to t_lo; the inverse runs them in the reverse order, each pass's
# stages reversed
CORE_PASSES = (("a", 3, 256), ("b", 4, 16), ("c", 4, 1))


def core_index(layout: str, j, i):
    """Coefficient x that thread j of a group holds as v[i] in a layout
    (ntt_device.cuh la_/lb_/lc_base + off; numpy arrays broadcast)."""
    if layout == "a":
        return 2 * j + (i & 1) + 256 * (i >> 1)
    if layout == "b":
        return 256 * (j >> 4) + (j & 15) + 16 * i
    if layout == "c":
        return 16 * j + i
    raise ValueError(f"core layout {layout!r}")


def core_pad(x):
    """Word of coefficient x in an exchange buffer (ntt_device.cuh pad)."""
    return x + (x >> 5)


def core_twiddle(layout: str, S: int, t_lo: int, j, s: int, i):
    """Twiddle-table index of the butterfly in stage s (stride t_lo *
    2^(S-1-s)) of a pass whose lower element is the thread's v[i], as the
    kernel computes it: (m_unit + G) * 2^s + (i' >> (S - s)), i' the
    element's index in its unit."""
    units = CORE_PER >> S
    m_unit = (1 << CORE_LOG_N) // (t_lo << S)
    G = 0 * j if layout == "a" else j >> 4 if layout == "b" else j
    return ((m_unit + G) << s) + ((i // units) >> (S - s))


def tables(params: Params, device) -> torch.Tensor:
    """(crt, 4, n) int32 bit patterns of (w, w', w_inv, w_inv') per channel
    (params.ntt_tables), cached per device."""
    key = (params.poly_len, params.moduli, str(device))
    if key not in _TABLES:
        arr = np.stack([np.stack(t) for t in params.ntt_tables])
        _TABLES[key] = u32_bits(arr, device)
    return _TABLES[key]


def _launch(params: Params, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    if (x.dtype != torch.int32 or x.shape[-2:] != (2, params.poly_len)
            or params.poly_len_log2 != CORE_LOG_N):
        raise ValueError(f"expected int32 (..., 2, {1 << CORE_LOG_N}), got "
                         f"{x.dtype} {tuple(x.shape)} at n = {params.poly_len}")
    x = x.contiguous()
    if x.data_ptr() % 16:                 # the kernel loads 16 bytes a thread
        x = x.clone()
    tb = tables(params, x.device)
    _build.require_cuda(x, tb)
    out = torch.empty_like(x)
    q0, q1 = params.moduli
    _build.launch("ntt_inverse" if inverse else "ntt_forward", "sdk_ntt",
                  x.device, x.data_ptr(), out.data_ptr(), tb.data_ptr(),
                  x.numel() // params.poly_len, params.poly_len_log2, q0, q1,
                  int(inverse), _build.stream_of(x))
    return out


def ntt_forward_plain(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT with exact int64 butterflies (x + w*y, x - w*y) mod q in
    the reference's stage order, each stage in place on its two halves."""
    n = params.poly_len
    q = moduli_column(params, x.device, 2)            # (crt, 1, 1)
    w_all = tables(params, x.device)[:, 0].to(torch.int64) & 0xFFFFFFFF
    op = (x.to(torch.int64) & 0xFFFFFFFF) % q.reshape(-1, 1)
    lead = op.shape[:-1]
    for mm in range(params.poly_len_log2):
        m = 1 << mm
        v = op.view(lead + (m, 2, n >> (mm + 1)))
        w = w_all[:, m:2 * m].unsqueeze(-1)           # (crt, m, 1)
        xs, ys = v[..., 0, :], v[..., 1, :]
        ys.mul_(w).remainder_(q)                      # w*y
        t = xs + q - ys                               # x - w*y + q
        xs.add_(ys).remainder_(q)
        torch.remainder(t, q, out=ys)
    return op.to(torch.int32)


def ntt_inverse_plain(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT with exact int64 butterflies ((x + y)/2, (x - y)*w) mod q,
    each stage in place on its two halves; the table's inverse twiddles are
    pre-halved, so 1/n is carried."""
    n = params.poly_len
    q = moduli_column(params, x.device, 2)
    inv2 = (q + 1) // 2
    w_all = tables(params, x.device)[:, 2].to(torch.int64) & 0xFFFFFFFF
    op = x.to(torch.int64) % q.reshape(-1, 1)
    lead = op.shape[:-1]
    for mm in reversed(range(params.poly_len_log2)):
        h = 1 << mm
        v = op.view(lead + (h, 2, n >> (mm + 1)))
        w = w_all[:, h:2 * h].unsqueeze(-1)
        xs, ys = v[..., 0, :], v[..., 1, :]
        t = xs + q - ys                               # x - y + q < 2q
        xs.add_(ys).mul_(inv2).remainder_(q)
        torch.mul(t, w, out=ys).remainder_(q)
    return op.to(torch.int32)


def ntt_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: int32 (..., crt, n) holding any uint32 bit patterns -> canonical
    NTT residues of the values mod q_c."""
    if x.device.type == "cuda":
        return _launch(params, x, inverse=False)
    if x.device.type == "cpu":
        return ntt_forward_plain(params, x)
    raise ValueError(f"unsupported device {x.device}")


def ntt_inverse(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: int32 (..., crt, n) residues < q_c -> coefficients in [0, q_c)."""
    if x.device.type == "cuda":
        return _launch(params, x, inverse=True)
    if x.device.type == "cpu":
        return ntt_inverse_plain(params, x)
    raise ValueError(f"unsupported device {x.device}")
