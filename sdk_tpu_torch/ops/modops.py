"""Modular arithmetic helpers on int64 tensors.

The JAX build carried every value in uint32 lanes (sdk_tpu/ops/modops.py):
64-bit coefficient-domain values as (hi, lo) pairs and mulhi from 16-bit
limbs. PyTorch has int64 on every device, so here:

- NTT-domain residues (< q < 2^28) are int32 tensors ``(..., crt, n)``;
  products are formed in int64 (< 2^56, exact);
- raw coefficient-domain values mod Q = q0*q1 < 2^57 are int64 tensors
  ``(..., n)``;
- Shoup companions floor(w * 2^32 / q) (< 2^32) are kept as int32 tensors
  holding the uint32 bit pattern, which is what the CUDA kernels read.

``torch.uint32`` is not used: on the CPU PyTorch cannot add, subtract, shift
or compare it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import Params


def shoup_companion(w: int, q: int) -> int:
    """floor(w * 2^32 / q), truncated to 32 bits."""
    return ((w << 32) // q) & 0xFFFFFFFF


def u32_bits(a: np.ndarray, device) -> torch.Tensor:
    """uint32-valued numpy array -> int32 tensor with the same bit pattern."""
    arr = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def shoup_companion_arr(params: Params, w: np.ndarray) -> np.ndarray:
    """Per channel floor(w * 2^32 / q_c) for an NTT matrix (..., crt, n) of
    values < q_c, as uint32."""
    out = np.empty(w.shape, dtype=np.uint64)
    for c, q in enumerate(params.moduli):
        out[..., c, :] = (w[..., c, :].astype(np.uint64) << np.uint64(32)) \
            // np.uint64(q)
    return out.astype(np.uint32)


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device``. To a CUDA card it goes through a pinned
    buffer and a copy that does not make the host wait for the work queued
    on the stream (a pageable one would); torch's pinned allocator keeps
    the buffer until the copy has run. Elsewhere as ``.to`` does."""
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


_MODULI: dict = {}


def moduli_column(params: Params, device, ndim_after: int = 1) -> torch.Tensor:
    """The CRT moduli as an int64 tensor shaped (crt, 1, ..., 1) with
    ``ndim_after`` trailing unit dims, for broadcasting against
    (..., crt, *rest) tensors. Made once a device (an upload each call
    would make the host wait for the card's queued work); callers never
    write into it."""
    key = (params.moduli, str(torch.device(device)), ndim_after)
    q = _MODULI.get(key)
    if q is None:
        q = _MODULI[key] = torch.tensor(
            params.moduli, dtype=torch.int64, device=device
        ).reshape((-1,) + (1,) * ndim_after)
    return q


def reduce_channels(params: Params, raw: torch.Tensor) -> torch.Tensor:
    """raw int64 (..., n) values (< 2^63) -> int32 residues (..., crt, n)."""
    q = moduli_column(params, raw.device)
    return (raw.unsqueeze(-2) % q).to(torch.int32)


def crt_compose(params: Params, residues: torch.Tensor) -> torch.Tensor:
    """Residues (..., crt, n) in [0, q_c) -> the unique int64 value mod
    Q = q0*q1 (Garner, as params.crt_compose_2)."""
    q0, q1 = params.moduli
    x0 = residues[..., 0, :].to(torch.int64)
    x1 = residues[..., 1, :].to(torch.int64)
    t = ((x1 - x0 % q1) % q1) * params.inv_q0_mod_q1 % q1
    return x0 + q0 * t


def neg_mod_Q(params: Params, raw: torch.Tensor) -> torch.Tensor:
    """Q - x on raw values; 0 maps to Q, not 0 (reference invert_poly
    semantics, which the gadget digits of a negated zero depend on)."""
    return params.modulus - raw


def add_mod(params: Params, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channelwise (a + b) mod q_c of int32 residues (..., crt, n)."""
    q = moduli_column(params, a.device).to(torch.int32)
    s = a + b
    return torch.where(s >= q, s - q, s)


def mul_mod(params: Params, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channelwise a * b mod q_c of int32 residues (..., crt, n)."""
    q = moduli_column(params, a.device)
    return (a.to(torch.int64) * b.to(torch.int64) % q).to(torch.int32)
