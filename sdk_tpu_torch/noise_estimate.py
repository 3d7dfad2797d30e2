"""Closed-form noise-growth model and error-probability estimate for Spiral
parameter selection (reference lib/spiral-rs/src/noise_estimate.rs).

Used by the params store to validate configurations at selection time
(gate: estimated log2 error probability <= -40)."""

from __future__ import annotations

import math

from .params import HAMMING_WEIGHT, Params, Q2_VALUES


def _get_base(t: int, q: int) -> float:
    q_bits = math.ceil(math.log2(q))
    return 2.0 ** math.ceil(q_bits / t)


def _gadget_exp_factor(params: Params, t: int, z: float) -> float:
    return t * params.poly_len * params.noise_width ** 2 * z ** 2 / 4.0


def estimate_noise(params: Params) -> float:
    """Variance of the final response noise (noise_estimate.rs:53-98)."""
    s = params
    nu1, nu2 = s.db_dim_1, s.db_dim_2
    d = s.poly_len
    sigma = s.noise_width
    q = s.modulus
    n_used = 1

    z_gsw = _get_base(s.t_gsw, q)
    m_gsw = (n_used + 1) * s.t_gsw
    z_conv = _get_base(s.t_conv, q)
    z_exp_left = _get_base(s.t_exp_left, q)
    z_exp_right = _get_base(s.t_exp_right, q)

    num_exp_reg = nu1 + 1
    sigma_reg_2 = sigma ** 2
    sigma_gsw_2 = sigma ** 2

    if s.expand_queries:
        # factor of d deliberately excluded, as in the reference (it models
        # measured noise better than the paper's bound)
        sigma_reg_2 = (4.0 ** num_exp_reg) * sigma ** 2 \
            * (1.0 + s.t_exp_left * z_exp_left ** 2 / 3.0)
        num_exp_gsw = math.ceil(math.log2(s.t_gsw * nu2)) + 1
        sigma_gsw_2 = (4.0 ** num_exp_gsw) * sigma ** 2 \
            * (1.0 + s.t_exp_right * z_exp_right ** 2 / 3.0)
        sigma_gsw_2 = sigma_gsw_2 * 2.0 * HAMMING_WEIGHT \
            + 2.0 * _gadget_exp_factor(s, s.t_conv, z_conv)

    sigma_0_2 = (2.0 ** nu1) * n_used * d * (s.pt_modulus / 2.0) ** 2 * sigma_reg_2
    sigma_rest = nu2 * d * m_gsw * z_gsw ** 2 / 2.0 * sigma_gsw_2
    sigma_r_2 = sigma_0_2 + sigma_rest
    sigma_packing_2 = d * s.n * s.t_conv * sigma ** 2 * z_conv ** 2 / 4.0
    return sigma_r_2 + sigma_packing_2


def estimate_log2_err_prob(params: Params) -> float:
    """log2 of the per-response decoding-failure probability
    (noise_estimate.rs:100-118). Selection gate: <= -40."""
    s = params
    q2 = Q2_VALUES[s.q2_bits]
    s_e = estimate_noise(params)
    p_f = float(s.pt_modulus)
    q_f = float(s.modulus)
    q_prime_f = float(q2)

    modswitch_adj = (1.0 / 8.0) * (4.0 * p_f / q_f)
    thresh = 0.25 - modswitch_adj
    assert 0.0 < thresh < 0.25

    s_round_2 = s.noise_width ** 2 * s.poly_len / 4.0
    numer = -math.pi * thresh ** 2
    denom = s_e * (p_f / q_f) ** 2 + s_round_2 * (p_f / q_prime_f) ** 2
    p_single_err_log = math.log(2.0) + numer / denom
    p_err_log = p_single_err_log + math.log(s.n * s.n * s.poly_len)
    return p_err_log * math.log2(math.e)
