"""Sharded serving over a mesh of devices (ports sdk_tpu/ops/shard.py).

The reference's only cross-node pattern is "shard DB rows, sum partial
responses" (lib/doublepir/src/bin/e2e.rs:60-106; enabled by LWE linearity).
Here the dense encrypted index is cut into one tensor per device of a
(dp, db) mesh, every shard scans its own rows, and the partial scan results
are summed exactly mod q by kernel M (csrc/psum_mod.cu).

Mesh axes:
  dp : data parallel over the trials (independent PIR sub-problems;
       reference rayon par_iter, lib/server/src/server.rs:53-88)
  db : first-dimension rows (dim0) of the DB tensor; the scan's partial
       sums over a dp group's db shards are reduced by kernel M.

A mesh is an explicit (dp, db) array of torch devices. By default it takes
distinct visible CUDA devices; an explicit device list may name a device
several times (logical shards, the port's counterpart of XLA's virtual host
devices: the tests, ``--cpu`` and chip_smoke.py use them). Partials on other
devices than a group's first are moved there with ``Tensor.to`` (a no-op for
logical shards) before kernel M sums them.

Across processes (JAX's mesh axis that spans processes), each rank of a
``torch.distributed`` group holds its own parts: ``psum_mod_group`` gathers
every rank's int32 parts and runs kernel M on them on every rank.
"""

from __future__ import annotations

import ctypes
import datetime
import functools

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..params import Params
from . import spiral as sj

MASK32 = 0xFFFFFFFF
MAX_PARTS = 64          # kernel M's part pointers (a kernel parameter)


class Mesh:
    """A (dp, db) array of torch devices; ``shape`` reads like the JAX
    mesh's (``mesh.shape["db"]``)."""

    def __init__(self, devices):
        arr = np.empty((len(devices), len(devices[0])), dtype=object)
        for g, row in enumerate(devices):
            if len(row) != arr.shape[1]:
                raise ValueError("mesh rows must have one length")
            for j, d in enumerate(row):
                arr[g, j] = torch.device(d)
        self.devices = arr
        self.shape = {"dp": arr.shape[0], "db": arr.shape[1]}

    @property
    def home(self) -> torch.device:
        """Device (0, 0): expansion, pack and encode run there."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` itself if it is None or a Mesh; anything else is refused."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an ops.shard.Mesh (make_mesh, "
                        f"mesh_from_spec), got {type(mesh).__name__}")
    return mesh


def _visible(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """1- or 2-axis mesh (dp, db) over ``devices`` (default: the distinct
    visible CUDA devices); refuses more devices than there are."""
    devs = _visible(devices)
    n = n_devices or len(devs)
    if n < 1 or n > len(devs):
        raise ValueError(f"a mesh of {n} devices, but {len(devs)} are "
                         f"available")
    dp = dp or 1
    if n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    devs = devs[:n]
    per = n // dp
    return Mesh([devs[g * per:(g + 1) * per] for g in range(dp)])


def mesh_from_spec(spec: str, devices=None) -> Mesh:
    """Parse a serving-config mesh spec into a (dp, db) mesh.

    Accepted forms: "8" (8 devices, all on the db axis), "db=8",
    "dp=2,db=4", "dp=2" (db gets the rest of the devices)."""
    spec = spec.strip()
    if not spec:
        raise ValueError("empty mesh spec")
    axes: dict[str, int] = {}
    if "=" not in spec:
        axes["db"] = int(spec)
    else:
        for part in spec.split(","):
            k, v = part.split("=")
            k = k.strip()
            if k not in ("dp", "db"):
                raise ValueError(f"unknown mesh axis {k!r} (want dp/db)")
            axes[k] = int(v)
    dp = axes.get("dp", 1)
    n = dp * axes["db"] if "db" in axes else len(_visible(devices))
    return make_mesh(n, dp=dp, devices=devices)


# logical CPU shards a --cpu --mesh spec may name (as the JAX tests' 8
# virtual host devices)
CPU_SHARDS = 8


def mesh_from_cli(spec: str, cpu: bool) -> Mesh:
    """A server's --mesh SPEC: over the visible cards, or with --cpu over
    CPU_SHARDS logical CPU shards; a spec that does not fit ends the
    program with its reason."""
    try:
        mesh = mesh_from_spec(spec, devices=["cpu"] * CPU_SHARDS if cpu
                              else None)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")
    print(f"Serving over mesh {mesh.shape}", flush=True)
    return mesh


# ---------------------------------------------------------------------------
# kernel M: the exact sum of partials, reduced once
# ---------------------------------------------------------------------------

def _moduli(q, n_chan: int) -> list[int]:
    moduli = [int(q)] if isinstance(q, (int, np.integer)) else [int(x) for x in q]
    if len(moduli) not in (1, n_chan) or len(moduli) > 2:
        raise ValueError(f"psum_mod: {len(moduli)} moduli for {n_chan} "
                         f"channels")
    return moduli


def _check_parts(parts: list) -> None:
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"psum_mod: 1..{MAX_PARTS} parts, got {len(parts)}")
    p0 = parts[0]
    for p in parts:
        if p.dtype != torch.int32 or p.shape != p0.shape:
            raise ValueError(f"psum_mod: int32 parts of one shape wanted, got "
                             f"{[(str(x.dtype), tuple(x.shape)) for x in parts]}")


def psum_mod_plain(parts: list, q) -> torch.Tensor:
    """psum_mod in plain PyTorch: the uint32 values summed in int64, then
    ``%`` per channel (axis 0 of each part when two moduli are given; q = 0
    keeps the sum mod 2^32). Returns int32 bit patterns."""
    _check_parts(parts)
    moduli = _moduli(q, parts[0].shape[0] if parts[0].ndim else 1)
    acc = sum(p.to(torch.int64) & MASK32 for p in parts)
    rows = acc.reshape(len(moduli), -1)
    out = torch.stack([r & MASK32 if m == 0 else r % m
                       for r, m in zip(rows, moduli)])
    return (((out + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32) \
        .reshape(parts[0].shape)


@functools.lru_cache(maxsize=None)
def reduction_constants(q: int) -> tuple[int, int, int]:
    """Kernel M's constants of one channel: (q, r, m) with r = 2^32 mod q
    and m = floor((2^64 - 1) / q), the Barrett multiplier of the kernel's
    __umul64hi; (0, 0, 0) for q = 0, the sum mod 2^32."""
    if q == 0:
        return 0, 0, 0
    if not 1 <= q < 1 << 32:
        raise ValueError(f"psum_mod: modulus {q} is not below 2^32")
    return q, (1 << 32) % q, ((1 << 64) - 1) // q


def _vec4(n: int, chan: int, *ptrs: int) -> bool:
    """Whether kernel M takes its 16-byte path: whole vectors in the tensor
    and in each channel, every pointer on 16 bytes; otherwise it takes its
    scalar path, equally exact."""
    return n % 4 == 0 and chan % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def psum_mod_vec4(parts: list, q) -> bool:
    """Whether kernel M reads these contiguous parts 16 bytes at a time (its
    output, a fresh allocation of the caching allocator, is aligned)."""
    n = parts[0].numel()
    moduli = _moduli(q, parts[0].shape[0] if parts[0].ndim else 1)
    return _vec4(n, n // len(moduli), *(p.data_ptr() for p in parts))


def _psum_mod_launch(parts: list, q) -> torch.Tensor:
    """Kernel M on the first part's CUDA device: one pass over the parts
    checks them (int32, one shape), moves any on another device there and
    takes their pointers; the output is the only allocation, and nothing is
    copied to the device (the pointers go by value in the kernel's
    parameters)."""
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"psum_mod: 1..{MAX_PARTS} parts, got {len(parts)}")
    dev, shape = parts[0].device, parts[0].shape
    held, ptrs, vec4 = [], [], True
    for p in parts:
        if p.dtype != torch.int32 or p.shape != shape:
            _check_parts(parts)
        if p.device != dev:
            p = p.to(dev, non_blocking=True)
        if not p.is_contiguous():
            p = p.contiguous()
        held.append(p)
        ptrs.append(p.data_ptr())
        vec4 = vec4 and ptrs[-1] % 16 == 0
    moduli = _moduli(q, shape[0] if len(shape) else 1)
    out = torch.empty_like(held[0])
    n = out.numel()
    chan = n // len(moduli) if len(moduli) == 2 else n
    c0, c1 = (reduction_constants(m) for m in (moduli + moduli)[:2])
    vec4 = vec4 and _vec4(n, chan, out.data_ptr())
    _build.launch("psum_mod", "sdk_psum_mod", dev,
                  (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs), n, chan,
                  *c0, *c1, int(vec4), out.data_ptr(), _build.stream_of(out))
    return out


def psum_mod(parts: list, q) -> torch.Tensor:
    """Exact sum of D int32 partial tensors of one shape, reduced once:
    mod q_c per channel c (axis 0) for ``q`` = the Spiral moduli, one
    modulus for all, or mod 2^32 for q = 0 (the checklist's wrapping sums).
    Runs on the first part's device (the others are moved there): kernel M
    on a CUDA tensor, psum_mod_plain on a CPU tensor."""
    dev = parts[0].device
    if dev.type == "cuda":
        return _psum_mod_launch(parts, q)
    if dev.type == "cpu":
        return psum_mod_plain([p.to(dev) for p in parts], q)
    raise ValueError(f"unsupported device {dev}")


# ---------------------------------------------------------------------------
# kernel M across processes: a torch.distributed group
# ---------------------------------------------------------------------------

GROUP_BACKENDS = ("gloo", "nccl")
# how long a rendezvous or a collective waits for the other ranks: a rank
# that died must not leave the others blocked for torch's default 10 min
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def init_group(backend: str, init_method: str, rank: int, world_size: int):
    """``torch.distributed.init_process_group`` with everything explicit:
    the rendezvous (``file://PATH``, a FileStore every rank shares, or
    ``tcp://localhost:PORT``), this rank and the world size; collectives
    wait GROUP_TIMEOUT at most. Returns the default group."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=GROUP_TIMEOUT)
    return dist.group.WORLD


def all_gather_parts(local_parts: list, group=None) -> list:
    """This rank's k int32 parts of one shape -> the W * k parts of every
    rank of ``group`` in rank order (rank r's at r * k ... r * k + k - 1),
    views of one (W, k, ...) tensor on this rank's device (its first
    part's). Every rank must pass k parts of the same shape and dtype:
    all_gather moves equal shapes.

    One all_gather of the stacked parts. NCCL gathers on the card; gloo
    gathers on the host, so CUDA parts are copied to the host and the
    gathered parts back to the device, each copy explicit here. Refuses,
    before any collective: no parts, parts of mixed shapes or dtypes, W * k
    above MAX_PARTS (kernel M's part pointers), a backend other than gloo
    or NCCL, an NCCL group with CPU parts."""
    _check_parts(local_parts)
    k, dev = len(local_parts), local_parts[0].device
    world = dist.get_world_size(group)
    if world * k > MAX_PARTS:
        raise ValueError(f"psum_mod_group: {world} ranks x {k} parts is more "
                         f"than kernel M's {MAX_PARTS}")
    backend = str(dist.get_backend(group))
    if backend not in GROUP_BACKENDS:
        raise ValueError(f"psum_mod_group: backend {backend!r}, want one of "
                         f"{GROUP_BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"psum_mod_group: an NCCL group with parts on {dev}")
    stack = torch.stack([p.to(dev) for p in local_parts])
    wire = stack.cpu() if backend == "gloo" else stack
    gathered = wire.new_empty((world,) + tuple(stack.shape))
    dist.all_gather(list(gathered.unbind(0)), wire, group=group)
    return list(gathered.to(dev).flatten(0, 1).unbind(0))


def psum_mod_group(local_parts: list, q, group=None) -> torch.Tensor:
    """psum_mod over a process group, the counterpart of JAX's
    ``psum_mod(x, q, axis_name)`` over a mesh axis that spans processes
    (sdk_tpu/ops/shard.py:42): ``local_parts`` are this rank's k int32
    partials (a JAX process's local devices); ``q`` takes psum_mod's forms
    (one modulus, the Spiral moduli per channel on axis 0, or 0 for the
    sum mod 2^32). The W * k parts of all_gather_parts (every rank must
    pass the same shape) are summed in rank order on this rank's device:
    kernel M on a CUDA tensor, psum_mod_plain on a CPU tensor. Every rank
    returns the same result."""
    _check_parts(local_parts)
    p0 = local_parts[0]
    _moduli(q, p0.shape[0] if p0.ndim else 1)
    return psum_mod(all_gather_parts(local_parts, group), q)


# ---------------------------------------------------------------------------
# the Spiral index over a mesh
# ---------------------------------------------------------------------------

class ShardedDb:
    """The dense int8 DB tensor (spiral.db_shape) cut over a mesh: shard
    (g, j) holds the 4-column words [j * jw_l, (j + 1) * jw_l) of axis 3
    (dim0 over "db") and the trials [g * t_l, (g + 1) * t_l) of axis 5
    (over "dp"), contiguous on mesh.devices[g, j]. Each shard is itself a
    dense index of dim0 / db columns and t_l trials."""

    def __init__(self, params: Params, mesh: Mesh, shards: list):
        self.params = params
        self.mesh = mesh
        self.shards = shards
        self.shape = sj.db_shape(params)
        self.jw_l = self.shape[3] // mesh.shape["db"]
        self.t_l = self.shape[5] // mesh.shape["dp"]

    @staticmethod
    def check(params: Params, mesh: Mesh) -> None:
        shape = sj.db_shape(params)
        if shape[3] % mesh.shape["db"] or shape[5] % mesh.shape["dp"]:
            raise ValueError(
                f"a (dp={mesh.shape['dp']}, db={mesh.shape['db']}) mesh does "
                f"not divide dim0 / 4 = {shape[3]} words and {shape[5]} "
                f"trials")

    @classmethod
    def zeros(cls, params: Params, mesh: Mesh) -> "ShardedDb":
        cls.check(params, mesh)
        shape = list(sj.db_shape(params))
        shape[3] //= mesh.shape["db"]
        shape[5] //= mesh.shape["dp"]
        return cls(params, mesh, [
            [torch.zeros(shape, dtype=torch.int8, device=mesh.devices[g, j])
             for j in range(mesh.shape["db"])]
            for g in range(mesh.shape["dp"])])

    @classmethod
    def from_dense(cls, params: Params, mesh: Mesh,
                   dense: torch.Tensor) -> "ShardedDb":
        cls.check(params, mesh)
        if tuple(dense.shape) != sj.db_shape(params) or dense.dtype != torch.int8:
            raise ValueError(f"bad DB tensor {dense.dtype} {tuple(dense.shape)}")
        jw = dense.shape[3] // mesh.shape["db"]
        tl = dense.shape[5] // mesh.shape["dp"]
        return cls(params, mesh, [
            [dense[:, :, :, j * jw:(j + 1) * jw, :, g * tl:(g + 1) * tl]
             .to(mesh.devices[g, j]).contiguous()
             for j in range(mesh.shape["db"])]
            for g in range(mesh.shape["dp"])])

    def zero_(self) -> None:
        for row in self.shards:
            for s in row:
                s.zero_()

    def read_slice(self, c: int, z0: int, z1: int) -> torch.Tensor:
        """The whole index's [c, z0:z1] slice, (z1 - z0, L, jw, inst,
        trials, num_per, 4), on the host."""
        return torch.cat([
            torch.cat([s[c, z0:z1].cpu() for s in row], dim=2)
            for row in self.shards], dim=4)

    def write_slice_(self, c: int, z0: int, z1: int,
                     block: torch.Tensor) -> None:
        """Inverse of read_slice: each shard takes its part of the block."""
        for g, row in enumerate(self.shards):
            for j, s in enumerate(row):
                s[c, z0:z1] = block[:, :, j * self.jw_l:(j + 1) * self.jw_l, :,
                                    g * self.t_l:(g + 1) * self.t_l]


def fold_columns(params: Params, inter: torch.Tensor, v_foldings: torch.Tensor,
                 v_neg: torch.Tensor) -> torch.Tensor:
    """A batch's scan output (crt, z, inst, trials, num_per, NQ, 2) and its
    folding keys and their negations (NQ, db_dim_2, 2, 2*t_gsw, crt, z) ->
    folded raw cts (NQ, inst, trials, 2, 1, z): every query folds in the same
    launch of kernel F per round (server_jax.py:565-603)."""
    crt, z, inst, trials, npr, nq, _ = inter.shape
    cts = inter.permute(5, 2, 3, 4, 6, 0, 1).reshape(
        nq, inst * trials, npr, 2, 1, crt, z)
    folded = sj.fold_ciphertexts(params, sj.from_ntt(params, cts),
                                 v_foldings, v_neg)
    return folded.reshape(nq, inst, trials, 2, 1, z)


class ShardedSpiralScan:
    """The sharded scan + fold of a SpiralServerTorch batch
    (shard.py:119-187): kernel C per (dp, db) shard over its local dim0 rows
    of the query columns, kernel M over each dp group's db shards, kernel F
    per dp group over its trials; the fold outputs are gathered in trial
    order on the home device for G and D."""

    def __init__(self, params: Params, mesh: Mesh):
        ShardedDb.check(params, mesh)
        self.params = params
        self.mesh = mesh

    def shard_db(self, dense: torch.Tensor) -> ShardedDb:
        """Cut a dense DB tensor (spiral.db_shape) over the mesh."""
        return ShardedDb.from_dense(self.params, self.mesh, dense)

    def scan_fold(self, db: ShardedDb, q_all: torch.Tensor, nq: int,
                  v_foldings: torch.Tensor, v_neg: torch.Tensor) -> torch.Tensor:
        """q_all: (crt, z, dim0, R) scan columns, column 2*i + r row r of
        query i (R / 2 >= nq; columns past 2 * nq are fillers); v_foldings,
        v_neg: (nq, ...) on the home device. Returns the folded cts (nq,
        inst, trials, 2, 1, z) on the home device."""
        params, mesh = self.params, self.mesh
        d0 = 4 * db.jw_l
        R = q_all.shape[-1]
        cols = [q_all[:, :, j * d0:(j + 1) * d0].contiguous()
                for j in range(mesh.shape["db"])]
        folded = []
        for g, row in enumerate(db.shards):
            parts = [sj.firstdim_multiply(params, shard,
                                          cols[j].to(shard.device,
                                                     non_blocking=True))
                     for j, shard in enumerate(row)]
            full = psum_mod(parts, params.moduli)
            inter = full.reshape(full.shape[:-1] + (R // 2, 2))[..., :nq, :]
            dev = full.device
            folded.append(fold_columns(
                params, inter, v_foldings.to(dev, non_blocking=True),
                v_neg.to(dev, non_blocking=True)).to(mesh.home,
                                                     non_blocking=True))
        return torch.cat(folded, dim=2)


class DoublePirShardedScan:
    """DoublePIR online scan over a row-sharded packed DB (shard.py:200-247):
    every db shard of the mesh's first dp row scans its rows; all arithmetic
    is mod 2^32, so the shards' rows concatenate without any reduction."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = list(mesh.devices[0])

    def shard_rows(self, db_packed) -> list:
        """Pad the rows to a multiple of the db axis and cut them, one
        block of rows per device (uint32 numpy array or int32 tensor)."""
        from ..doublepir.kernels import as_u32_tensor

        n = len(self.devices)
        t = as_u32_tensor(db_packed, "cpu")
        pad = (-t.shape[0]) % n
        if pad:
            t = torch.cat([t, t.new_zeros((pad, t.shape[1]))])
        per = t.shape[0] // n
        return [t[i * per:(i + 1) * per].to(d)
                for i, d in enumerate(self.devices)]

    def answer_firstlevel(self, db_sharded: list, queries_q1: list,
                          total_rows: int) -> np.ndarray:
        """queries_q1: one (m3, 1) u32 column per row batch. Returns the
        concatenated a_1 (total_rows, 1), each row taking its own batch's
        column (scheme.answer's per-batch loop)."""
        from ..doublepir.kernels import (as_u32_tensor, mat_mul_vec_packed,
                                         to_numpy_u32)

        q_wide = np.concatenate(queries_q1, axis=1)
        full = np.concatenate([
            to_numpy_u32(mat_mul_vec_packed(s, as_u32_tensor(q_wide, s.device)))
            for s in db_sharded])[:total_rows]
        nq = len(queries_q1)
        batch_sz = total_rows // nq
        batch_of_row = np.minimum(np.arange(total_rows) // batch_sz, nq - 1)
        return np.take_along_axis(full, batch_of_row[:, None], axis=1)
