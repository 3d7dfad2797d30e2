"""Device-resident DoublePIR server for the byte-packed checklist configs
(ports sdk_tpu/doublepir/server_jax.py).

The production deployment (reference js/bridge/src/doublepir_lib.rs:118-129:
``1024,6.4,92681,92683,32,464``, ~2^36 bloom bits) serves 1-bit entries
with p=464, so DbInfo.packing == 8 and ne == x == 1: every DB element is
exactly one byte of the packed bloom bitfield, stored as

    db_i8[r, c] = byte[r, c] - 128          (ONE int8 per element)

- 1 B/element: the production DB is 8.6 GB on the device; no unsquished or
  32-bit copy ever exists.
- The stored tensor IS the left operand of kernel K (csrc/dp_dot_i8.cu),
  exact mod 2^32 for any K in its three forms: the answer's level-1 select
  multiplies 32 bits on the CUDA cores; the setup's tiled form (N > 8) and
  the answer's narrow form (the hint product a_2, N <= 8) run one int8
  tensor-core product a byte plane of the u32 operand in s32 runs of at
  most 65,536 k, so the JAX program's limb planes and its int32
  accumulation bound are gone.
- The batched answer makes ONE pass over the DB: each row multiplies only
  the query column its row batch selects (reference answer loops batches
  serially, doublepir.rs:261-316).

Offset corrections (exact mod 2^32), both folded into the kernel's add row:
    byte           = db_i8 + 128
    setup DB elem  = byte - p//2  ->  H1 = db_i8*A1 + (128 - p//2)*colsum(A1)
    answer DB elem = byte         ->  a_1 = db_i8*Q1 + 128*colsum(Q1)

Bit-exact vs the host scheme (scheme.setup/answer -> client recover);
general (non-checklist) configs use kernels.DoublePirAnswerTorch /
device_kernels. On CPU tensors every product runs its plain version.

With a mesh (ops/shard.Mesh) the DB rows are cut over the devices of the
mesh's "db" axis (the reference chunk-and-sum pattern,
lib/doublepir/src/bin/e2e.rs:60-106): the level-1 pass, the row-batch
select, the squish and H1's digit planes are row-local, and the three
contractions over l (h2 at setup; msg0, a_2 and h_2 of an answer) are
wrapping sums of the shards' partials, kernel M in its mod-2^32 form.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ops.shard import check_mesh, psum_mod
from . import scheme
from .database import DbInfo
from .debug import print_checksum
from .kernels import (answer_products, as_u32_tensor, to_numpy_u32,
                      u32_values, u32_wrap, unsquish, wrapping_matmul_plain)
from .matrix import (SEEDS_SHORT, SQUISH_BASIS, SQUISH_DELTA,
                     derive_from_seed_rows)
from .params import Params

ROW_ALIGN = 16            # bytes; K's tensor-core forms read rows in 16-byte chunks
UPLOAD_CHUNK_BYTES = 1 << 28
GLUE_ROWS = 512           # rows of H1 planes per elementwise glue step


def aligned_rows(rows: int, cols: int, device, fill: int = 0) -> torch.Tensor:
    """A (rows, cols) int8 view whose rows start ROW_ALIGN bytes apart in a
    (rows, cols rounded up) buffer: what kernel K reads without a copy."""
    stride = -(-cols // ROW_ALIGN) * ROW_ALIGN
    return torch.full((rows, stride), fill, dtype=torch.int8,
                      device=device)[:, :cols]


def _kernel_rows(a: torch.Tensor, align: int = 4) -> torch.Tensor:
    """``a`` itself if kernel K can read it in place (rows on ``align``-byte
    boundaries: 4 for the select form's words, 16 for the tensor-core
    forms' chunks; every row's last word or chunk inside the storage), else
    a copy in aligned rows."""
    rows, cols = a.shape
    end = a.storage_offset() + (rows - 1) * a.stride(0) + \
        -(-cols // align) * align
    if a.stride(1) == 1 and a.stride(0) % align == 0 \
            and a.data_ptr() % align == 0 and a.stride(0) >= cols \
            and end <= a.untyped_storage().nbytes():
        return a
    out = aligned_rows(rows, cols, a.device)
    out.copy_(a)
    return out


def _add_row(b: torch.Tensor, c: int):
    """c * colsum(b) mod 2^32, the row kernel K adds to every output row.
    The int32 bit patterns are summed as they are (each differs from its
    u32 value by a multiple of 2^32) into an int32 result, which keeps the
    sum mod 2^32, with no widened copy of b."""
    if c == 0:
        return None
    return u32_wrap(c * b.sum(0, dtype=torch.int32).to(torch.int64))


def _check_dot(a_lo, a_hi, b) -> None:
    planes = [a_lo] + ([a_hi] if a_hi is not None else [])
    for a in planes:
        if a.dtype != torch.int8 or a.shape != a_lo.shape or a.ndim != 2 \
                or a.device != b.device:
            raise ValueError("int8 planes of one shape on b's device wanted")
    if b.dtype != torch.int32 or b.ndim != 2 or b.shape[0] != a_lo.shape[1]:
        raise ValueError(f"b must be int32 bit patterns (K, N), got "
                         f"{b.dtype} {tuple(b.shape)} for K={a_lo.shape[1]}")


def _dot_plain(a_lo, a_hi, b, c: int, select: bool) -> torch.Tensor:
    a64 = a_lo.to(torch.int64)
    if a_hi is not None:
        a64 = a64 + (a_hi.to(torch.int64) << 7)
    b64 = u32_values(b)
    z = wrapping_matmul_plain(a64, b64) + c * b64.sum(0)
    if select:
        z = torch.gather(z, 1, batch_index(
            a_lo.shape[0], b.shape[1], b.device)[:, None])[:, 0]
    return u32_wrap(z)


def _plane_rows(a_lo, a_hi):
    """Both planes in the tensor-core forms' 16-byte rows (``_kernel_rows``)
    sharing one stride."""
    a_lo = _kernel_rows(a_lo, ROW_ALIGN)
    if a_hi is not None:
        a_hi = _kernel_rows(a_hi, ROW_ALIGN)
        if a_hi.stride(0) != a_lo.stride(0):
            raise ValueError("the two planes must share their row stride")
    return a_lo, a_hi


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _dot_tiled_launch(a_lo, a_hi, b, c: int):
    """The tiled form (N > 8): rows aligned to 16 bytes, b's columns padded
    with zeros to a multiple of 4 where they are not (16-byte copies)."""
    M, K = a_lo.shape
    N = b.shape[1]
    a_lo, a_hi = _plane_rows(a_lo, a_hi)
    add = _add_row(b, c)
    ldb = -(-N // 4) * 4
    if ldb != N or not b.is_contiguous() or b.data_ptr() % 16:
        padded = b.new_zeros((K, ldb))
        padded[:, :N] = b
        b = padded
    out = torch.empty((M, N), dtype=torch.int32, device=b.device)
    _build.require_cuda(b, out, *([add] if add is not None else []))
    _build.launch("dp_dot_i8", "sdk_dp_dot_i8_tiled", b.device,
                  a_lo.data_ptr(), _ptr(a_hi), a_lo.stride(0), b.data_ptr(),
                  ldb, N, _ptr(add), out.data_ptr(), M, K,
                  _build.stream_of(b))
    return out


def _dot_narrow_launch(a_lo, a_hi, b, c: int):
    """The narrow form (N <= 8, the answer's a_2): rows aligned to 16
    bytes, b as it is; the entry zeroes the output before the launch."""
    M, K = a_lo.shape
    N = b.shape[1]
    if not 1 <= N <= 8:
        raise ValueError(f"the narrow form takes 1..8 columns, got {N}")
    a_lo, a_hi = _plane_rows(a_lo, a_hi)
    add = _add_row(b, c)
    b = b.contiguous()
    out = torch.empty((M, N), dtype=torch.int32, device=b.device)
    _build.require_cuda(b, out, *([add] if add is not None else []))
    _build.launch("dp_dot_i8", "sdk_dp_dot_i8_narrow", b.device,
                  a_lo.data_ptr(), _ptr(a_hi), a_lo.stride(0), b.data_ptr(),
                  N, _ptr(add), out.data_ptr(), M, K, _build.stream_of(b))
    return out


def _dot_select_launch(a, b, c: int):
    """The select form (the level-1 pass): operand q is column q of b,
    contiguous, so a block of batch q reads only that column."""
    M, K = a.shape
    nq = b.shape[1]
    a = _kernel_rows(a)
    add = _add_row(b, c)
    bt = b.t().contiguous()
    out = torch.empty((M,), dtype=torch.int32, device=b.device)
    _build.require_cuda(bt, out, *([add] if add is not None else []))
    _build.launch("dp_dot_i8", "sdk_dp_dot_i8_select", b.device,
                  a.data_ptr(), a.stride(0), bt.data_ptr(), _ptr(add),
                  out.data_ptr(), M, K, M // nq, nq, _build.stream_of(bt))
    return out


def _dot_launch(a_lo, a_hi, b, c: int, select: bool) -> torch.Tensor:
    """Kernel K: the select form for the level-1 row-batch select (one
    plane), the narrow form for N <= 8, the tiled form for N > 8."""
    if select:
        if a_hi is not None:
            raise ValueError("the select form takes one plane")
        return _dot_select_launch(a_lo, b, c)
    if b.shape[1] <= 8:
        return _dot_narrow_launch(a_lo, a_hi, b, c)
    return _dot_tiled_launch(a_lo, a_hi, b, c)


def _dot(a_lo, a_hi, b, c: int, select: bool) -> torch.Tensor:
    _check_dot(a_lo, a_hi, b)
    if select and not 1 <= b.shape[1] <= min(8, a_lo.shape[0]):
        raise ValueError(f"a batch is 1..8 queries over at least as many "
                         f"rows, got {b.shape[1]} for {a_lo.shape[0]} rows")
    if b.device.type == "cuda":
        return _dot_launch(a_lo, a_hi, b, c, select)
    if b.device.type == "cpu":
        return _dot_plain(a_lo, a_hi, b, c, select)
    raise ValueError(f"unsupported device {b.device}")


def dot_i8_u32(a_i8: torch.Tensor, b: torch.Tensor, c: int = 0) -> torch.Tensor:
    """(a_i8 : (M, K) int8) @ (b : (K, N) u32 bit patterns) + c * colsum(b),
    exact mod 2^32, as int32 bit patterns (kernel K)."""
    return _dot(a_i8, None, b, c, select=False)


def dot_i8pair_u32(a_lo: torch.Tensor, a_hi: torch.Tensor, b: torch.Tensor,
                   c: int = 0) -> torch.Tensor:
    """(a_lo + (a_hi << 7)) @ b + c * colsum(b), exact mod 2^32, for digit
    operands below 512 stored as two int8 planes, a_lo in [0, 128) and a_hi
    in [0, 4) (kernel K, pair form)."""
    return _dot(a_lo, a_hi, b, c, select=False)


def batch_index(rows: int, nq: int, device) -> torch.Tensor:
    """The row batch of every DB row: rows // nq rows each, the last batch
    taking the remainder (reference doublepir.rs:261-316)."""
    bs = rows // nq
    return torch.clamp(torch.arange(rows, device=device) // bs, max=nq - 1)


def dot_i8_select(a_i8: torch.Tensor, b: torch.Tensor, c: int = 0) -> torch.Tensor:
    """The diagonal of the batched level-1 product: out[r] = (a_i8 @ b +
    c * colsum(b))[r, batch_index(r)], (M,) int32 bit patterns. The kernel
    computes only the selected column of each row, in one pass over a."""
    return _dot(a_i8, None, b, c, select=True)


def _unsquish_limbs(h1_sq: torch.Tensor):
    """Squished H1 (rows, C) words -> (lo, hi) int8 (rows, 3C): the packed
    10-bit digits' low-7 / high-3 bits, extracted once at install time so
    the answer's hint matvec reads two int8 planes straight into kernel K."""
    d = unsquish(h1_sq, h1_sq.shape[1] * SQUISH_DELTA)
    return (d & 127).to(torch.int8), (d >> 7).to(torch.int8)


def _squish_digits(d: torch.Tensor) -> torch.Tensor:
    """(rows, 3C) int64 digits < 2^10 -> (rows, C) packed words; the fields
    occupy disjoint bit ranges, so the sum never carries."""
    d = d.reshape(d.shape[0], -1, SQUISH_DELTA)
    return sum(d[:, :, k] << (SQUISH_BASIS * k)
               for k in range(SQUISH_DELTA)).to(torch.int32)


class ChecklistServerTorch:
    """Full device-resident DoublePIR server for P=8 (byte-element) DBs.

    ``device`` is the card unless the caller passes ``"cpu"``, which runs
    every product's plain version. With ``mesh`` the DB rows shard over the
    devices of its "db" axis (the JAX server's ``mesh=``); ``device`` is
    then the mesh's home device, where the answer's sums land."""

    def __init__(self, num_entries: int, params: Params,
                 bit_bytes: np.ndarray | None, *, db_dev=None, mesh=None,
                 device="cuda"):
        info = DbInfo.new(num_entries, 1, params)
        if not (info.packing == 8 and info.ne == 1 and info.x == 1):
            raise ValueError(
                f"not a byte-element checklist config: packing={info.packing}"
                f" ne={info.ne} x={info.x} (use DoublePirAnswerTorch)")
        self.params = params
        self.info = info
        self.mesh = check_mesh(mesh)
        self.device = mesh.home if mesh is not None else torch.device(device)
        l, m = params.l, params.m
        # row count padded so every shard's rows are a multiple of the
        # squish width (server_jax.py:141-146); pad rows hold byte 0 ==
        # int8 -128, so their level-1 output is (-128 + 128) * colsum == 0,
        # exactly a zero-digit row
        self.devices = list(mesh.devices[0]) if mesh is not None \
            else [self.device]
        ndev = len(self.devices)
        self.l_pad = -(-l // (SQUISH_DELTA * ndev)) * (SQUISH_DELTA * ndev) \
            if mesh is not None else l
        self.rows_per = self.l_pad // ndev
        if db_dev is not None:
            if db_dev.shape != (l, m) or db_dev.dtype != torch.int8:
                raise ValueError(f"db_dev must be ({l}, {m}) int8")
            if mesh is None:
                self.db = _kernel_rows(db_dev.to(self.device))
            else:
                self.db = [self._shard_rows(db_dev, j, fill=-128)
                           for j in range(ndev)]
        else:
            # byte 0 == int8 -128: tail elements past the bit array
            bits = np.asarray(bit_bytes, dtype=np.uint8)
            self.db = [aligned_rows(self.rows_per, m, d, fill=-128)
                       for d in self.devices]
            for j, shard in enumerate(self.db):
                self._upload_bits(bits, (num_entries + 7) // 8, shard,
                                  j * self.rows_per)
            if mesh is None:
                self.db = self.db[0]
        self._h1_sq_host = None  # host (n*delta, ceil(l/3)) u32 (lazy)
        self.h1_lo = None       # device (n*delta, 3*ceil(l/3)) int8 digit lo7
        self.h1_hi = None       # device (n*delta, 3*ceil(l/3)) int8 digit hi3
        self.a_2_t = None       # host   (n, l padded to 3) u32
        self._a2_pad_dev = None  # device (l padded to 3, n) u32 bit patterns

    def _upload_bits(self, bit_bytes: np.ndarray, nbytes: int,
                     target: torch.Tensor, row0: int) -> None:
        """One byte per element, LSB-first bit groups (Db.from_packed_bits
        P=8): DB rows [row0, row0 + target rows) uploaded into ``target`` in
        row chunks; the -128 happens on the device (byte ^ 0x80 read as
        int8), so the host holds no second copy."""
        l, m = self.params.l, self.params.m
        nb = min(nbytes, l * m, bit_bytes.shape[0])
        rows = min(target.shape[0], l - row0)
        step = max(1, UPLOAD_CHUNK_BYTES // m)
        for r0 in range(0, rows, step):
            lo = (row0 + r0) * m
            hi = min((row0 + min(r0 + step, rows)) * m, nb)
            if lo >= hi:
                break
            x = (torch.from_numpy(bit_bytes[lo:hi]).to(target.device) ^ 0x80) \
                .view(torch.int8)
            full = (hi - lo) // m
            target[r0:r0 + full].copy_(x[:full * m].view(full, m))
            if (hi - lo) % m:
                target[r0 + full, :(hi - lo) % m] = x[full * m:]

    def _shard_rows(self, arr, j: int, fill: int = 0) -> torch.Tensor:
        """Rows [j * rows_per, (j + 1) * rows_per) of ``arr`` (int8 (l, m)
        or int32 bit patterns (rows, n)) on shard j's device, padded with
        ``fill`` past the array's end (server_jax.py:169-180); int8 rows
        are aligned for kernel K."""
        rp = self.rows_per
        dev = self.devices[j]
        part = arr[j * rp:(j + 1) * rp]
        if arr.dtype == torch.int8:
            out = aligned_rows(rp, arr.shape[1], dev, fill=fill)
        else:
            out = torch.full((rp, arr.shape[1]), fill, dtype=arr.dtype,
                             device=dev)
        out[:part.shape[0]] = part.to(dev)
        return out

    # ---- setup (reference doublepir.rs:76-108, all products on device) ----

    def _stream_derived_to_device(self, key: bytes, rows: int, cols: int,
                                  chunk_bytes: int = 1 << 25) -> torch.Tensor:
        """AES-derive a public matrix in row chunks straight into a device
        buffer: peak host memory is ONE chunk, and the bytes cross the
        host->device link exactly once (the streaming analog of the
        reference's matrix_mul_derive_fn, derivation.rs:28-60)."""
        crows = max(1, chunk_bytes // (cols * 4))
        buf = torch.empty((rows, cols), dtype=torch.int32, device=self.device)
        for r0 in range(0, rows, crows):
            nr = min(crows, rows - r0)
            buf[r0:r0 + nr] = as_u32_tensor(
                derive_from_seed_rows(r0, nr, cols, key), self.device)
        return buf

    def setup_streamed(self, chunk_bytes: int = 1 << 25) -> list[np.ndarray]:
        """Production-path setup with the REAL AES-derived A1/A2, never
        materialized on host: stream both matrices to the device in chunks,
        then run the standard device hint program. Bit-exact vs
        setup(scheme.init(...)). A2's upload doubles as its serving
        residency (_a2_pad_dev)."""
        if self.mesh is not None:
            raise ValueError("streamed setup is single-device "
                             "(server_jax.py:225)")
        params, info = self.params, self.info
        a1 = self._stream_derived_to_device(
            SEEDS_SHORT[0], params.m, params.n, chunk_bytes)
        a2 = self._stream_derived_to_device(
            SEEDS_SHORT[1], params.l // info.x, params.n, chunk_bytes)
        return self.setup([a1, a2])

    def setup(self, shared: list | None = None) -> list[np.ndarray]:
        """Returns the client hint [h_2]; retains H1's digit planes on the
        device and A2^T on host for answers. `shared` = [A1 (m,n), A2
        (l,n)], uint32 numpy arrays or int32 bit-pattern tensors."""
        params, info = self.params, self.info
        shared = shared if shared is not None else scheme.init(info, params)
        if self.mesh is not None:
            return self._setup_sharded(shared)
        a_1 = as_u32_tensor(shared[0], self.device)
        a_2 = as_u32_tensor(shared[1], self.device)
        p, delta = params.p, params.delta()
        n, l = a_1.shape[1], params.l
        # H1 = (byte - p/2) @ A1  =  db_i8 @ A1 + (128 - p/2)*colsum(A1)
        h1 = dot_i8_u32(self.db, a_1, c=128 - p // 2)
        v = u32_values(h1.t().contiguous())          # (n, l)
        del h1
        l3 = -(-l // SQUISH_DELTA) * SQUISH_DELTA
        self.h1_lo = aligned_rows(n * delta, l3, self.device)
        self.h1_hi = aligned_rows(n * delta, l3, self.device)
        h2_planes = []
        for f in range(delta):
            # base-p digit plane f of H1^T, raw in [0, p), split as low 7
            # bits + high bits (<= 3); H2 = centered-digits @ A2 =
            # digits @ A2 - (p/2)*colsum(A2)
            d = v % p
            v = v // p
            lo = aligned_rows(n, l, self.device)
            hi = aligned_rows(n, l, self.device)
            lo.copy_(d & 127)
            hi.copy_(d >> 7)
            del d
            h2_planes.append(dot_i8pair_u32(lo, hi, a_2, c=-(p // 2)))
            # expand()'s row order [i*delta + f]; the pad columns stay zero
            # digits, as the host squish pads
            self.h1_lo[f::delta, :l] = lo
            self.h1_hi[f::delta, :l] = hi
        h2 = torch.stack(h2_planes, dim=1).reshape(n * delta, -1)
        self._h1_sq_host = None  # reconstructed lazily on first .h1_sq read
        self._install_a2(shared[1])
        return [to_numpy_u32(h2)]

    def _setup_sharded(self, shared: list) -> list[np.ndarray]:
        """setup over the row shards (server_jax.py:374-420): H1 and its
        digit planes are row-local, with the pad rows' digits masked to zero
        (the host squish pads with zero digits, and the -p/2 correction
        makes the pad columns of H1 nonzero); each shard's H2 partial
        carries its own -(p/2) * colsum(A2 rows) row, so the wrapping sum of
        the partials (kernel M, q = 0) is digits @ A2 - (p/2) * colsum(A2)
        mod 2^32."""
        params = self.params
        p, delta = params.p, params.delta()
        l, rp = params.l, self.rows_per
        a_2 = as_u32_tensor(shared[1], "cpu")
        n = a_2.shape[1]
        self.h1_lo, self.h1_hi, parts = [], [], []
        for j, (dev, db) in enumerate(zip(self.devices, self.db)):
            a_1 = as_u32_tensor(shared[0], dev)
            a2_j = self._shard_rows(a_2, j)
            v = u32_values(dot_i8_u32(db, a_1, c=128 - p // 2).t().contiguous())
            valid = max(0, min(rp, l - j * rp))
            lo_j = aligned_rows(n * delta, rp, dev)
            hi_j = aligned_rows(n * delta, rp, dev)
            planes = []
            for f in range(delta):
                d = v % p
                v = v // p
                d[:, valid:] = 0
                lo = aligned_rows(n, rp, dev)
                hi = aligned_rows(n, rp, dev)
                lo.copy_(d & 127)
                hi.copy_(d >> 7)
                planes.append(dot_i8pair_u32(lo, hi, a2_j, c=-(p // 2)))
                lo_j[f::delta] = lo
                hi_j[f::delta] = hi
            self.h1_lo.append(lo_j)
            self.h1_hi.append(hi_j)
            parts.append(torch.stack(planes, dim=1).reshape(n * delta, -1))
        h2 = psum_mod(parts, 0)
        self._h1_sq_host = None
        self._install_a2(shared[1])
        return [to_numpy_u32(h2)]

    @property
    def h1_sq(self):
        """Squished H1 (the persistence/wire format). The serving path only
        reads the (lo, hi) int8 digit planes; persistence reads reconstruct
        the squished form from them on the device (digit = lo + (hi<<7);
        repack 3x10 bits/u32) and fetch once, cached here."""
        if self._h1_sq_host is None and self.h1_lo is not None:
            los = self.h1_lo if self.mesh is not None else [self.h1_lo]
            his = self.h1_hi if self.mesh is not None else [self.h1_hi]
            cols = []
            for h1_lo, h1_hi in zip(los, his):
                parts = []
                for r0 in range(0, h1_lo.shape[0], GLUE_ROWS):
                    lo = h1_lo[r0:r0 + GLUE_ROWS].to(torch.int64)
                    hi = h1_hi[r0:r0 + GLUE_ROWS].to(torch.int64)
                    parts.append(to_numpy_u32(_squish_digits(lo + (hi << 7))))
                cols.append(np.concatenate(parts))
            # the shards' squished columns side by side (server_jax.py
            # out_specs P(None, "db"))
            self._h1_sq_host = np.concatenate(cols, axis=1)
        return self._h1_sq_host

    def _install_h1_planes(self, h1_sq_dev: torch.Tensor) -> None:
        """Derive the (lo, hi) int8 digit planes of H1 from the squished
        form (the persistence/wire format stays h1_sq; the planes are the
        answer path's serving layout)."""
        rows, c = h1_sq_dev.shape
        cw = c // len(self.devices)
        self.h1_lo, self.h1_hi = [], []
        for j, dev in enumerate(self.devices):
            sq = h1_sq_dev[:, j * cw:(j + 1) * cw].contiguous().to(dev)
            h1_lo = aligned_rows(rows, cw * SQUISH_DELTA, dev)
            h1_hi = aligned_rows(rows, cw * SQUISH_DELTA, dev)
            for r0 in range(0, rows, GLUE_ROWS):
                lo, hi = _unsquish_limbs(sq[r0:r0 + GLUE_ROWS])
                h1_lo[r0:r0 + GLUE_ROWS] = lo
                h1_hi[r0:r0 + GLUE_ROWS] = hi
            self.h1_lo.append(h1_lo)
            self.h1_hi.append(h1_hi)
        if self.mesh is None:
            self.h1_lo, self.h1_hi = self.h1_lo[0], self.h1_hi[0]

    def _install_a2(self, a_2) -> None:
        """A2 row-padded to SQUISH_DELTA stays on the device (msg[0] =
        unsquish(a_1t) @ A2); a_2_t is the HOST answer glue's operand
        (scheme.answer reads it), kept only when A2 came from the host."""
        a2_dev = as_u32_tensor(a_2, self.device)
        pad = (-a2_dev.shape[0]) % SQUISH_DELTA
        if pad:
            a2_dev = torch.cat([a2_dev, a2_dev.new_zeros((pad, a2_dev.shape[1]))])
        self.a_2_t = None
        if isinstance(a_2, np.ndarray):
            self.a_2_t = np.ascontiguousarray(to_numpy_u32(a2_dev).T)
        # sharded: each shard's rows of A2, zero past l (server_jax.py:351)
        self._a2_pad_dev = a2_dev if self.mesh is None else [
            self._shard_rows(a2_dev, j) for j in range(len(self.devices))]

    def install_hint(self, h1_sq: np.ndarray, a_2) -> None:
        """Restore path: install a previously computed squished H1 instead
        of re-running the setup products (the shared matrices re-derive
        deterministically from the fixed public AES seeds, so only the
        computed hint needs persisting: the reference preprocess->serve
        flow, lib/doublepir/src/bin/preprocess.rs)."""
        h1_host = np.asarray(h1_sq, dtype=np.uint32)
        if self.mesh is not None:
            # the sharded layout has l_pad / 3 squished columns; the extra
            # columns are zero digits
            cols = self.l_pad // SQUISH_DELTA
            fit = np.zeros((h1_host.shape[0], cols), dtype=np.uint32)
            fit[:, :min(cols, h1_host.shape[1])] = h1_host[:, :cols]
            h1_host = fit
        self._install_h1_planes(as_u32_tensor(h1_host, self.device))
        self._h1_sq_host = h1_host
        self._install_a2(a_2)

    def install_state(self, state: dict) -> None:
        """Adopt a whole serving state as numpy arrays: ``db`` (l, m) int8,
        the digit planes ``h1_lo`` / ``h1_hi`` (n*delta, 3*ceil(l/3)) int8,
        ``a2_pad`` (l padded to 3, n) uint32 and ``a_2_t`` (its transpose,
        or None), e.g. convert.checklist_from_jax of a ChecklistServerJax."""
        if self.mesh is not None:
            raise ValueError("install_state takes an unsharded state")
        l, m = self.params.l, self.params.m
        rows = self.params.n * self.params.delta()
        l3 = -(-l // SQUISH_DELTA) * SQUISH_DELTA
        want = {"db": (l, m), "h1_lo": (rows, l3), "h1_hi": (rows, l3),
                "a2_pad": (l3, self.params.n)}
        for name, shape in want.items():
            if tuple(state[name].shape) != shape:
                raise ValueError(f"{name}: shape {tuple(state[name].shape)} "
                                 f"!= {shape}")
        for name in ("db", "h1_lo", "h1_hi"):
            arr = np.array(state[name], dtype=np.int8)   # a writable copy
            setattr(self, name, _kernel_rows(
                torch.from_numpy(arr).to(self.device)))
        self._a2_pad_dev = as_u32_tensor(state["a2_pad"], self.device)
        self.a_2_t = state.get("a_2_t")
        self._h1_sq_host = None

    # ---- answer (reference doublepir.rs:246-350, one pass, diag select) --

    def _answer_fused(self, q1: torch.Tensor, q2: torch.Tensor):
        """The whole batched answer on the device: the level-1 DB pass with
        the row-batch select (K), the a_1 -> squished-a_1^T glue transform
        (transpose_expand_concat_cols_squish for cols=concat=1: exact digit
        arithmetic, identical to the host), msg[0] and h_2 (one launch of
        L's answer form), and the hint matvec a_2 (K's narrow form, pair)."""
        a_1 = dot_i8_select(self.db, q1, c=128)                 # (l,)
        return self._answer_rest(a_1, self._a2_pad_dev, self.h1_lo,
                                 self.h1_hi, q2)

    def _answer_rest(self, a_1, a2p, h1_lo, h1_hi, q2):
        """Everything of an answer after level 1, over one set of rows:
        the squish of a_1 (delta, ceil(rows/3)), msg[0], a_2 and h_2."""
        p, delta = self.params.p, self.params.delta()
        v = u32_values(a_1)
        pad = (-v.shape[0]) % SQUISH_DELTA
        digs = []
        for _ in range(delta):
            digs.append(torch.nn.functional.pad(v % p, (0, pad)))
            v = v // p
        a_1t = _squish_digits(torch.stack(digs))      # (delta, ceil(rows/3))
        msg0, h_2 = answer_products(a_1t, a2p, q2)     # one L launch
        a_2 = dot_i8pair_u32(h1_lo, h1_hi, q2)
        return msg0, a_2, h_2

    def _answer_sharded(self, q1_all: np.ndarray, q2_all: np.ndarray):
        """The answer over the row shards (server_jax.py:486-501): per shard
        the level-1 pass of its rows, each row batch's rows against its own
        query column (kernel K's select form, one launch per batch that
        meets the shard), then the row-local rest; the three contractions
        over l are summed by kernel M mod 2^32 on the home device."""
        nq = q1_all.shape[1]
        bs = self.params.l // nq
        rp = self.rows_per
        outs = []
        for j, dev in enumerate(self.devices):
            q1 = as_u32_tensor(q1_all, dev)
            r0 = j * rp
            segs = []
            for b in range(nq):
                lo = max(r0, b * bs)
                hi = min(r0 + rp, self.l_pad if b == nq - 1 else (b + 1) * bs)
                if lo < hi:
                    segs.append(dot_i8_select(self.db[j][lo - r0:hi - r0],
                                              q1[:, b:b + 1], c=128))
            q2 = as_u32_tensor(q2_all[r0:r0 + rp], dev)
            outs.append(self._answer_rest(torch.cat(segs), self._a2_pad_dev[j],
                                          self.h1_lo[j], self.h1_hi[j], q2))
        return tuple(psum_mod([o[k] for o in outs], 0) for k in range(3))

    def answer(self, queries: list[list[np.ndarray]]) -> list[np.ndarray]:
        """Bit-exact mirror of scheme.answer for this config (x = ne = 1)."""
        m = self.params.m
        nq = len(queries)
        q1_all = np.concatenate([q[0][:m] for q in queries], axis=1)
        q2_all = np.concatenate([q[1] for q in queries], axis=1)
        if self.mesh is not None:
            # the client's queries have l rounded up to 3 rows; pad to l_pad
            if q2_all.shape[0] < self.l_pad:
                q2_all = np.vstack([q2_all, np.zeros(
                    (self.l_pad - q2_all.shape[0], nq), dtype=q2_all.dtype)])
            msg0, a_2_all, h_2_all = self._answer_sharded(q1_all, q2_all)
        else:
            l3 = self.h1_lo.shape[1]
            if q2_all.shape[0] != l3:
                raise ValueError(f"second-level queries must have {l3} rows, "
                                 f"got {q2_all.shape[0]}")
            msg0, a_2_all, h_2_all = self._answer_fused(
                as_u32_tensor(q1_all, self.device),
                as_u32_tensor(q2_all, self.device))
        msg: list[np.ndarray] = [to_numpy_u32(msg0)]
        a_2_np, h_2_np = to_numpy_u32(a_2_all), to_numpy_u32(h_2_all)
        # same named fingerprints as the host scheme (scheme.answer) and
        # the TS client: a Python/TS/device divergence localizes to the
        # first differing name (reference matrix.rs:176-196 pattern)
        print_checksum("h1", msg[0])
        for k in range(nq):
            msg.append(np.ascontiguousarray(a_2_np[:, k : k + 1]))
            msg.append(np.ascontiguousarray(h_2_np[:, k : k + 1]))
            print_checksum("a_2", msg[-2])
            print_checksum("h_2", msg[-1])
        return msg
