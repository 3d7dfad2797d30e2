"""Negacyclic NTT over the CRT channels: kernel group A.

``ntt_forward`` / ``ntt_inverse`` take int32 residues ``(..., crt, n)`` and
return canonical int32 residues in [0, q_c), word-identical to
sdk_tpu/ops/ntt_jax.py and the host oracle sdk_tpu/ntt_host.py. A CUDA
tensor runs the hand-written kernel (csrc/ntt.cu); a CPU tensor runs the
plain version beside it.

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


def tables(params: Params, device) -> torch.Tensor:
    """(crt, 4, n) int32 bit patterns of (w, w', w_inv, w_inv') per channel
    (params.ntt_tables), cached per device."""
    key = (params.poly_len, params.moduli, str(device))
    if key not in _TABLES:
        arr = np.stack([np.stack(t) for t in params.ntt_tables])
        _TABLES[key] = u32_bits(arr, device)
    return _TABLES[key]


def _launch(params: Params, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    if x.dtype != torch.int32 or x.shape[-2:] != (2, params.poly_len):
        raise ValueError(f"expected int32 (..., 2, {params.poly_len}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
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
    the reference's stage order."""
    n = params.poly_len
    q = moduli_column(params, x.device, 2)            # (crt, 1, 1)
    w_all = tables(params, x.device)[:, 0].to(torch.int64) & 0xFFFFFFFF
    op = (x.to(torch.int64) & 0xFFFFFFFF) % q.reshape(-1, 1)
    lead = op.shape[:-1]
    for mm in range(params.poly_len_log2):
        m = 1 << mm
        v = op.reshape(lead + (m, 2, n >> (mm + 1)))
        w = w_all[:, m:2 * m].unsqueeze(-1)           # (crt, m, 1)
        wy = v[..., 1, :] * w % q
        xs = v[..., 0, :]
        op = torch.stack([(xs + wy) % q, (xs - wy) % q], dim=-2
                         ).reshape(lead + (n,))
    return op.to(torch.int32)


def ntt_inverse_plain(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT with exact int64 butterflies ((x + y)/2, (x - y)*w) mod q;
    the table's inverse twiddles are pre-halved, so 1/n is carried."""
    n = params.poly_len
    q = moduli_column(params, x.device, 2)
    inv2 = (q + 1) // 2
    w_all = tables(params, x.device)[:, 2].to(torch.int64) & 0xFFFFFFFF
    op = x.to(torch.int64) % q.reshape(-1, 1)
    lead = op.shape[:-1]
    for mm in reversed(range(params.poly_len_log2)):
        h = 1 << mm
        v = op.reshape(lead + (h, 2, n >> (mm + 1)))
        w = w_all[:, h:2 * h].unsqueeze(-1)
        xs, ys = v[..., 0, :], v[..., 1, :]
        op = torch.stack([(xs + ys) * inv2 % q, (xs - ys) % q * w % q],
                         dim=-2).reshape(lead + (n,))
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
