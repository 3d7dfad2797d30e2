"""Response encode on the device: modulus-switch rescale + bit-pack, so only
the wire bytes leave the card. Kernel group D (csrc/encode.cu). A read does
not launch D: kernel G encodes in the same launch as the pack
(ops/spiral.py pack_encode, csrc/encode_device.cuh holds the arithmetic
both kernels run); ResponseEncodePlan.encode is the standalone counterpart
of encode_jax.py:99, and its plan (widths, word count, encode_plain) is
what G's out_words mode follows.

Ports sdk_tpu/ops/encode_jax.py. Reference semantics: rescale
(lib/spiral-rs/src/arith.rs:429-444) and encode (lib/server/src/server.rs
:101-134); wire layout = write_arbitrary_bits (util.rs:289-321), fields
packed LSB-first into a little-endian bitstream.

For odd Q, rescale(x, Q, c) = floor((x*c + Q//2) / Q) mod c, and with
N = x*c + Q//2 the quotient floor(N/Q) = low32(N - (N mod Q)) * Q^{-1}
mod 2^32 exactly (it is < 2^32); N mod Q comes from the two CRT residues.
No 85-bit product or 57-bit divide is formed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..arith import log2_ceil
from ..params import Params, Q2_VALUES

from .. import _build

_M32 = 0xFFFFFFFF


def rescale_pair(params: Params, x: torch.Tensor, out_mod: int) -> torch.Tensor:
    """Elementwise rescale of int64 values in [0, Q) from Q to out_mod,
    bit-exact vs sdk_tpu.arith.rescale. Returns int64 in [0, out_mod)."""
    q0, q1 = params.moduli
    h = params.modulus // 2
    v = [((x % q) * (out_mod % q) + h % q) % q for q in (q0, q1)]
    t = ((v[1] - v[0] % q1) % q1) * params.inv_q0_mod_q1 % q1
    n_mod_q = v[0] + q0 * t                               # < Q
    low32_n = ((x & _M32) * out_mod + (h & _M32)) & _M32
    diff = (low32_n - (n_mod_q & _M32)) & _M32
    qinv = pow(params.modulus, -1, 1 << 32)
    # diff * qinv mod 2^32 without a 64-bit overflow: 16-bit halves of qinv
    r = (diff * (qinv & 0xFFFF) + (((diff * (qinv >> 16)) & 0xFFFF) << 16)) \
        & _M32
    return torch.where(r >= out_mod, r - out_mod, r)


class ResponseEncodePlan:
    """Bit-pack schedule for one parameter set on one device.

    encode(packed) rescales row 0 of each packed instance to q2 and the
    other rows to q1 = 4p, then packs the q2_bits-/q1_bits-wide fields into
    little-endian uint32 words (returned as int32 bit patterns)."""

    def __init__(self, params: Params, device):
        self.params = params
        self.device = torch.device(device)
        self.q1_val = 4 * params.pt_modulus
        self.q1_bits = log2_ceil(self.q1_val)
        self.q2_val = Q2_VALUES[params.q2_bits]
        self.q2_bits = params.q2_bits
        if max(self.q1_bits, self.q2_bits) > 32:
            raise ValueError("fields wider than 32 bits are not supported")
        n, z, inst = params.n, params.poly_len, params.instances
        self.num_bits = inst * (n * z * self.q2_bits
                                + n * n * z * self.q1_bits)
        self.num_bytes = ((self.num_bits + 63) // 64) * 8
        self.num_words = self.num_bytes // 4
        self._table = None

    def _gather_table(self):
        """(value index, bit index) of every stream bit, for the plain
        version; the padding bits point at an appended zero value."""
        if self._table is None:
            params = self.params
            n, z, inst = params.n, params.poly_len, params.instances
            widths = np.tile(np.concatenate([
                np.full(n * z, self.q2_bits, dtype=np.int64),
                np.full(n * n * z, self.q1_bits, dtype=np.int64)]), inst)
            src_idx = np.repeat(np.arange(widths.size), widths)
            offs = np.cumsum(widths) - widths
            src_bit = np.arange(self.num_bits) - np.repeat(offs, widths)
            pad = self.num_bytes * 8 - self.num_bits
            src_idx = np.concatenate([src_idx, np.full(pad, widths.size)])
            src_bit = np.concatenate([src_bit, np.zeros(pad, dtype=np.int64)])
            self._table = (torch.from_numpy(src_idx).to(self.device),
                           torch.from_numpy(src_bit).to(self.device))
        return self._table

    def encode_plain(self, packed: torch.Tensor) -> torch.Tensor:
        inst = self.params.instances
        row0 = rescale_pair(self.params, packed[:, 0], self.q2_val)
        rest = rescale_pair(self.params, packed[:, 1:], self.q1_val)
        vals = torch.cat([row0.reshape(inst, -1), rest.reshape(inst, -1)],
                         dim=1).reshape(-1)
        vals = torch.cat([vals, vals.new_zeros(1)])
        src_idx, src_bit = self._gather_table()
        bits = (vals[src_idx] >> src_bit) & 1
        shifts = torch.arange(32, device=vals.device)
        words = (bits.reshape(-1, 32) << shifts).sum(dim=1)
        # the uint32 bit pattern as int32
        return torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                           words).to(torch.int32)

    def _launch(self, packed: torch.Tensor) -> torch.Tensor:
        params = self.params
        packed = packed.contiguous()
        _build.require_cuda(packed)
        words = torch.empty(self.num_words, dtype=torch.int32,
                            device=packed.device)
        q0, q1 = params.moduli
        _build.launch(
            "encode", "sdk_encode", packed.device, packed.data_ptr(),
            words.data_ptr(), self.num_words, params.n, params.poly_len,
            params.instances, self.q2_bits, self.q1_bits, self.q2_val,
            self.q1_val, q0, q1, params.inv_q0_mod_q1, params.modulus,
            pow(params.modulus, -1, 1 << 32), _build.stream_of(packed))
        return words

    def encode(self, packed: torch.Tensor) -> torch.Tensor:
        """packed: int64 (instances, n+1, n, poly_len) in [0, Q). Returns the
        response as int32 words holding the little-endian uint32 stream."""
        shape = (self.params.instances, self.params.n + 1, self.params.n,
                 self.params.poly_len)
        if packed.dtype != torch.int64 or tuple(packed.shape) != shape:
            raise ValueError(f"encode: expected int64 {shape}, got "
                             f"{packed.dtype} {tuple(packed.shape)}")
        if packed.device.type == "cuda":
            return self._launch(packed)
        if packed.device.type == "cpu":
            return self.encode_plain(packed)
        raise ValueError(f"unsupported device {packed.device}")

    def to_bytes(self, words) -> bytes:
        """Host side: word array (torch or numpy) -> wire bytes."""
        if isinstance(words, torch.Tensor):
            words = words.cpu().numpy()
        out = np.asarray(words).astype(np.int32).view(np.uint32) \
            .astype("<u4").tobytes()
        if len(out) != self.num_bytes:
            raise ValueError(f"encode: {len(out)} bytes, want {self.num_bytes}")
        return out
