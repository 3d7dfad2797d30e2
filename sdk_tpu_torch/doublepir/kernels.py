"""DoublePIR's wrapping-u32 products on the card (ports
sdk_tpu/doublepir/jax_kernels.py).

Everything in DoublePIR is arithmetic mod 2^32. A uint32 matrix is carried
as an int32 tensor holding the same bit pattern (``ops.modops.u32_bits``;
PyTorch cannot add or shift ``torch.uint32`` on the CPU). On a CUDA tensor
the products run kernel L (csrc/dp_matmul_u32.cu: native wrapping 32-bit
multiply-add, the packed form extracting the 10-bit fields in registers);
on a CPU tensor they run the plain version beside it, int64 arithmetic
masked to 32 bits. The checklist answer's two products of one packed
operand (``answer_products``) run as one launch of L's answer form. The JAX module's int8 limb split, its K chunks of 2^16
and its row chunks of the unsquished copy bound int32 limb sums and TPU
temporaries, and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ops.modops import u32_bits
from .matrix import SQUISH_BASIS, SQUISH_DELTA

MASK32 = 0xFFFFFFFF
# elements of the (M, k, N) int64 product block a plain version forms at once
PLAIN_CHUNK_ELEMS = 1 << 24


def u32_values(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return t.to(torch.int64) & MASK32


def u32_wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values, taken mod 2^32 -> int32 bit patterns."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def as_u32_tensor(x, device) -> torch.Tensor:
    """A uint32 numpy array or an int32 bit-pattern tensor -> an int32
    tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise ValueError(f"u32 matrices are int32 tensors, got {x.dtype}")
        return x.to(device)
    return u32_bits(x, device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().cpu().numpy().view(np.uint32)


def wrapping_matmul_plain(a64: torch.Tensor, b64: torch.Tensor) -> torch.Tensor:
    """(M, K) int64 @ (K, N) int64 with every product and sum taken mod
    2^64 (the low 32 bits are the mod-2^32 result), as a multiply-and-sum
    over chunks of K: PyTorch has no int64 matmul on CUDA."""
    M, K = a64.shape
    N = b64.shape[1]
    out = torch.zeros((M, N), dtype=torch.int64, device=b64.device)
    kc = max(1, PLAIN_CHUNK_ELEMS // max(1, M * N))
    for k0 in range(0, K, kc):
        out += (a64[:, k0:k0 + kc, None] * b64[None, k0:k0 + kc, :]).sum(1)
    return out


def matmul_u32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return u32_wrap(wrapping_matmul_plain(u32_values(a), u32_values(b)))


def unsquish(m: torch.Tensor, orig_cols: int, basis: int = SQUISH_BASIS,
             delta: int = SQUISH_DELTA) -> torch.Tensor:
    """(rows, cols) packed words -> (rows, orig_cols) fields (matrix.py
    unsquish)."""
    shifts = torch.arange(delta, device=m.device, dtype=torch.int32) * basis
    out = (m.unsqueeze(-1) >> shifts) & ((1 << basis) - 1)
    return out.reshape(m.shape[0], -1)[:, :orig_cols]


def matmul_u32_packed_plain(a_packed: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    return matmul_u32_plain(unsquish(a_packed, b.shape[0]), b)


def _launch(a: torch.Tensor, b: torch.Tensor, packed: bool) -> torch.Tensor:
    a = a.contiguous()
    b = b.contiguous()
    _build.require_cuda(a, b)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=b.device)
    if out.numel():
        _build.launch("dp_matmul_u32", "sdk_dp_matmul_u32", b.device,
                      a.data_ptr(), a.shape[1], b.data_ptr(), out.data_ptr(),
                      a.shape[0], b.shape[0], b.shape[1], int(packed),
                      _build.stream_of(b))
    return out


def _dispatch(a: torch.Tensor, b: torch.Tensor, packed: bool) -> torch.Tensor:
    k = a.shape[1] * (SQUISH_DELTA if packed else 1)
    if a.dtype != torch.int32 or b.dtype != torch.int32 or a.ndim != 2 \
            or b.ndim != 2 or b.shape[0] != k or a.device != b.device:
        raise ValueError(
            f"matmul_u32 takes int32 bit patterns (M, K) @ (K, N) on one "
            f"device, got {a.dtype} {tuple(a.shape)} on {a.device} and "
            f"{b.dtype} {tuple(b.shape)} on {b.device} (packed={packed})")
    if b.device.type == "cuda":
        return _launch(a, b, packed)
    if b.device.type == "cpu":
        return (matmul_u32_packed_plain if packed else matmul_u32_plain)(a, b)
    raise ValueError(f"unsupported device {b.device}")


def matmul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping-u32 matmul (a: (M, K), b: (K, N), int32 bit patterns)."""
    return _dispatch(a, b, packed=False)


def mat_mul_vec_packed(a_packed: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """unsquish(a) @ b (a: (rows, cols) words of three 10-bit fields, b:
    (cols * 3, N); N can batch queries). The fields are extracted inside
    the kernel: no unsquished copy exists."""
    return _dispatch(a_packed, b, packed=True)


def mat_mul_transposed_packed(a_packed: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """unsquish(a) @ b.T (b: (rb, cols * 3); reference kernels.rs:180-278)."""
    return _dispatch(a_packed, b.t().contiguous(), packed=True)


# the fused answer launch's limits (csrc/dp_matmul_u32.cu answer_kernel)
ANSWER_MAX_ROWS = 8
ANSWER_MAX_N1 = 256


def answer_products_plain(a_packed: torch.Tensor, b0: torch.Tensor,
                          b1: torch.Tensor):
    """(unsquish(a) @ b0, unsquish(a) @ b1): the two plain packed
    products."""
    return (matmul_u32_packed_plain(a_packed, b0),
            matmul_u32_packed_plain(a_packed, b1))


def _answer_launch(a_packed: torch.Tensor, b0: torch.Tensor,
                   b1: torch.Tensor):
    a_packed = a_packed.contiguous()
    b0 = b0.contiguous()
    b1 = b1.contiguous()
    _build.require_cuda(a_packed, b0, b1)
    M, N0, N1 = a_packed.shape[0], b0.shape[1], b1.shape[1]
    # one zeroed buffer for both products: one memset, the kernel adds
    out = torch.zeros(M * (N0 + N1), dtype=torch.int32, device=b0.device)
    msg0, h = out[:M * N0].view(M, N0), out[M * N0:].view(M, N1)
    _build.launch("dp_matmul_u32", "sdk_dp_answer_u32", b0.device,
                  a_packed.data_ptr(), a_packed.shape[1], M, b0.data_ptr(),
                  N0, msg0.data_ptr(), b1.data_ptr(), N1, h.data_ptr(),
                  b0.shape[0], _build.stream_of(b0))
    return msg0, h


def answer_products(a_packed: torch.Tensor, b0: torch.Tensor,
                    b1: torch.Tensor):
    """unsquish(a) @ b0 and unsquish(a) @ b1 of one packed left operand
    (the checklist answer's msg0 = a_1t @ A2 and h_2 = a_1t @ q2): on a
    CUDA tensor one launch of kernel L's answer form (a at most
    ANSWER_MAX_ROWS rows, b1 at most ANSWER_MAX_N1 columns; wider shapes
    take two mat_mul_vec_packed launches), on a CPU tensor the plain
    products."""
    k = a_packed.shape[1] * SQUISH_DELTA if a_packed.ndim == 2 else -1
    for b in (b0, b1):
        if a_packed.dtype != torch.int32 or b.dtype != torch.int32 \
                or b.ndim != 2 or b.shape[0] != k or b.device != a_packed.device:
            raise ValueError(
                f"answer_products takes int32 bit patterns (M, K / 3) packed "
                f"@ (K, N) on one device, got {a_packed.dtype} "
                f"{tuple(a_packed.shape)} on {a_packed.device} and {b.dtype} "
                f"{tuple(b.shape)} on {b.device}")
    if b0.device.type == "cuda":
        if a_packed.shape[0] <= ANSWER_MAX_ROWS and \
                b1.shape[1] <= ANSWER_MAX_N1 and b0.numel() and b1.numel():
            return _answer_launch(a_packed, b0, b1)
        return mat_mul_vec_packed(a_packed, b0), mat_mul_vec_packed(a_packed,
                                                                    b1)
    if b0.device.type == "cpu":
        return answer_products_plain(a_packed, b0, b1)
    raise ValueError(f"unsupported device {b0.device}")


def matmul_u32_device(a: np.ndarray, b: np.ndarray,
                      device="cuda") -> np.ndarray:
    """Host-callable device matmul; drop-in for matrix.matmul_u32."""
    return to_numpy_u32(matmul_u32(as_u32_tensor(a, device),
                                   as_u32_tensor(b, device)))


def device_kernels(device="cuda"):
    """Host-callable (mat_mul_vec_packed, mat_mul_transposed_packed) pair,
    drop-in for scheme.answer(kernels=...). Either operand may be a uint32
    numpy array or an int32 bit-pattern tensor kept on the device."""

    def mv(a, b):
        return to_numpy_u32(mat_mul_vec_packed(as_u32_tensor(a, device),
                                               as_u32_tensor(b, device)))

    def mt(a, b):
        return to_numpy_u32(mat_mul_transposed_packed(
            as_u32_tensor(a, device), as_u32_tensor(b, device)))

    return mv, mt


class DoublePirAnswerTorch:
    """Device-resident DoublePIR online answer path for general configs:
    holds the squished DB and the squished H1 hint on the device; each call
    runs one packed matvec. The glue transform between the two levels
    (transpose_expand_concat_cols_squish) stays host-side numpy."""

    def __init__(self, db_packed: np.ndarray, h1_packed: np.ndarray,
                 device="cuda"):
        self.device = torch.device(device)
        self.db = as_u32_tensor(db_packed, self.device)
        self.h1 = as_u32_tensor(h1_packed, self.device)

    def db_rows_times(self, start: int, count: int,
                      q1: np.ndarray) -> np.ndarray:
        return to_numpy_u32(mat_mul_vec_packed(
            self.db[start:start + count], as_u32_tensor(q1, self.device)))

    def h1_times(self, q2: np.ndarray) -> np.ndarray:
        return to_numpy_u32(mat_mul_vec_packed(
            self.h1, as_u32_tensor(q2, self.device)))
