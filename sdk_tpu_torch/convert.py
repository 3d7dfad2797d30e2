"""State carried across from the JAX engine or the host oracle to the port.

The tests use these so that SpiralServerJax and SpiralServerTorch serve one
identical DB with one key set, and a ChecklistServerTorch answers from a
ChecklistServerJax's own hint. The Spiral functions return CPU tensors; move
them to a device with ``.to(device)`` (SpiralServerTorch.set_db does).
"""

from __future__ import annotations

import numpy as np
import torch

from .params import Params

from .ops.spiral import LIMB_BITS, NUM_LIMBS, CompactDb, db_limbs


def db_from_jax_planes(params: Params, planes) -> torch.Tensor:
    """The JAX engine's latency-layout limb planes (server_jax.py:84-88: a
    tuple of crt*NUM_LIMBS int8 arrays (z, inst, trials, num_per, dim0),
    plane c*NUM_LIMBS + k = limb k of channel c) -> the port's dense DB.
    The same holds for compact planes, with cap_bin in place of dim0."""
    limbs = np.stack([np.asarray(p) for p in planes]).astype(np.int64)
    limbs = limbs.reshape((params.crt_count, NUM_LIMBS) + limbs.shape[1:])
    vals = sum(limbs[:, k] << (LIMB_BITS * k) for k in range(NUM_LIMBS))
    return db_limbs(params, torch.from_numpy(vals))


def compact_from_jax(params: Params, planes, idx_j) -> CompactDb:
    """A JAX CompactDb's planes (crt*NUM_LIMBS int8 arrays (z, inst, trials,
    num_per, cap_bin)) and idx_j (num_per, cap_bin) -> the port's CompactDb.
    cap_bin must be a multiple of 4."""
    return CompactDb(db_from_jax_planes(params, planes),
                     torch.from_numpy(np.array(idx_j, dtype=np.int32)))


def db_from_host_tensor(params: Params, db_u64: np.ndarray) -> torch.Tensor:
    """server_host.build_db_tensor output (inst, trials, z, crt, num_per,
    dim0) uint64 residues -> the port's dense DB (limbs split on the host)."""
    vals = np.ascontiguousarray(db_u64.transpose(3, 2, 0, 1, 4, 5))
    if vals.max(initial=0) >> (LIMB_BITS * NUM_LIMBS):
        raise ValueError("DB residues must be < 2^28")
    return db_limbs(params, torch.from_numpy(vals.astype(np.int64)))


def pp_from_jax(pp_dev: dict) -> dict:
    """JAX pp_to_device dict of (w, w_shoup) uint32 arrays -> the port's
    dict of (w, w_shoup) int32 tensors holding the same bit patterns."""
    def keyed(pair):
        return tuple(torch.from_numpy(np.array(x, dtype=np.uint32)
                                      .view(np.int32)) for x in pair)

    out = {}
    for key, val in pp_dev.items():
        out[key] = [keyed(p) for p in val] if isinstance(val, list) \
            else keyed(val)
    return out


def checklist_from_jax(srv_jax) -> dict:
    """A ChecklistServerJax's serving state (single device, after setup or
    install_hint) as numpy arrays, in the form
    ChecklistServerTorch.install_state takes: the int8 DB, the (lo, hi)
    digit planes of H1, the row-padded A2 and its host transpose."""
    return {"db": np.asarray(srv_jax.db),
            "h1_lo": np.asarray(srv_jax.h1_lo),
            "h1_hi": np.asarray(srv_jax.h1_hi),
            "a2_pad": np.asarray(srv_jax._a2_pad_dev),
            "a_2_t": srv_jax.a_2_t}
