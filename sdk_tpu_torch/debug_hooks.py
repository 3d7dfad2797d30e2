"""Noise-localization debug hook.

Port of the reference's CLIENT_TEST affordance (lib/spiral-rs/src/client.rs:15,
lib/spiral-rs/src/server.rs:713-729 and :605-648 dec_to_raw): a test plants
the client's regev secret key plus the expected plaintext, and the *server*
decrypts the folded ciphertext for instance 0 / trial 0 mid-pipeline. If the
rounded decryption mismatches the target, the failure is localized to the
expand/scan/fold stages (before pack/encode), and the measured noise width
tells you how far over budget the pipeline is.

Enable with ``set_client_test(sk_reg, target)`` (both raw host arrays); the
engine (ops.server.SpiralServerTorch) checks a single read's folded ct with
``check_folded_ct`` before it launches the pack. Copied from
sdk_tpu.debug_hooks (numpy host code).
"""

from __future__ import annotations

import math

import numpy as np

from . import poly
from .params import Params

U64 = np.uint64

# (sk_reg raw (1, 1, poly_len) u64, target raw mod-p (1, 1, poly_len) u64)
_CLIENT_TEST: tuple[np.ndarray, np.ndarray] | None = None


class ClientTestFailure(AssertionError):
    """Mid-pipeline decryption mismatched the planted target."""

    def __init__(self, msg: str, noise_width_log2: float, first_bad: int):
        super().__init__(msg)
        self.noise_width_log2 = noise_width_log2
        self.first_bad = first_bad


def set_client_test(sk_reg: np.ndarray, target: np.ndarray) -> None:
    global _CLIENT_TEST
    sk = np.asarray(sk_reg, dtype=U64).reshape(1, 1, -1)
    tg = np.asarray(target, dtype=U64).reshape(1, 1, -1)
    _CLIENT_TEST = (sk, tg)


def clear_client_test() -> None:
    global _CLIENT_TEST
    _CLIENT_TEST = None


def client_test_active() -> bool:
    return _CLIENT_TEST is not None


def dec_to_raw(params: Params, dec: np.ndarray,
               target: np.ndarray) -> tuple[np.ndarray, float]:
    """Round a raw decryption down to mod-p and measure its noise against the
    planted target (reference server.rs:605-648 dec_to_raw).

    dec:    raw (1, 1, poly_len) u64 values mod Q (sk_full x folded ct)
    target: raw (1, 1, poly_len) u64 values mod p
    Returns (rounded mod-p array, log2 noise width 2*pi*var(noise)).
    """
    q = params.modulus
    p = params.pt_modulus
    scale_k = q // p
    val = dec.astype(np.int64)
    val = np.where(val > q // 2, val - q, val)
    val_rounded = np.rint(val.astype(np.float64) / scale_k).astype(np.int64)

    t = target.astype(np.int64)
    t_centered = np.where(t >= p // 2, t - p, t)
    noise = val - t_centered * scale_k
    wrap = p * scale_k
    noise = np.where(np.abs(noise) >= wrap // 2,
                     noise - np.sign(noise) * wrap, noise)

    out = np.where(val_rounded < 0, val_rounded + p, val_rounded)
    out = (out.astype(U64)) % U64(q)
    var = float(np.var(noise.astype(np.float64)))
    width_log2 = math.log2(2.0 * math.pi * var) if var > 0 else float("-inf")
    return out, width_log2


def check_folded_ct(params: Params, ct_raw: np.ndarray) -> float | None:
    """If the hook is planted, decrypt a folded (2, 1, poly_len) raw ct for
    instance 0 / trial 0 and assert it rounds to the target.

    Returns the measured noise width (log2) on success, None when inactive.
    Raises ClientTestFailure on mismatch.
    """
    if _CLIENT_TEST is None:
        return None
    sk_reg, target = _CLIENT_TEST
    sk_full = poly.to_ntt(params, np.concatenate(
        [sk_reg, poly.raw_identity(params, 1, 1)], axis=1))
    ct_ntt = poly.to_ntt(params, ct_raw.reshape(2, 1, params.poly_len))
    dec = poly.from_ntt(params, poly.multiply(params, sk_full, ct_ntt))
    rounded, width_log2 = dec_to_raw(params, dec, target)
    tgt = target % U64(params.pt_modulus)
    if not np.array_equal(rounded, tgt):
        bad = np.nonzero(rounded.reshape(-1) != tgt.reshape(-1))[0]
        first = int(bad[0])
        raise ClientTestFailure(
            f"CLIENT_TEST: folded ct decrypts wrong at {bad.size}/"
            f"{params.poly_len} coeffs (first at {first}: "
            f"{int(rounded.reshape(-1)[first])} != "
            f"{int(tgt.reshape(-1)[first])}); "
            f"noise width (s^2, log2) = {width_log2:.2f}",
            width_log2, first)
    return width_log2
