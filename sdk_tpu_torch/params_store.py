"""Parameter store: map (num_items_log2, item_size_bytes) -> Spiral params
(reference util.rs:265-287; the reference loads ../params_store.json, which
is not shipped in the repo — we synthesize entries from known-good base
configurations and validate them with the noise estimator at lookup time).

Scheme-shape rules:
  num_items = 2^(nu_1 + nu_2);  item bytes = instances * n^2 * poly_len * logp/8.
Base configs are the reference's production shapes (bin/server.rs:191-203,
e2e-tests/params/v0.json, v1.json).
"""

from __future__ import annotations

import json
import math

from .noise_estimate import estimate_log2_err_prob
from .params import Params, params_from_json_obj

P_ERR_GATE = -40.0

# (n, t_gsw, t_conv, t_exp_left, t_exp_right, q2_bits, version) known-good
# crypto shapes, smallest-response first
BASE_SHAPES = [
    dict(n=2, t_gsw=7, t_conv=3, t_exp_left=5, t_exp_right=5, q2_bits=22, version=1),
    dict(n=2, t_gsw=8, t_conv=4, t_exp_left=8, t_exp_right=56, q2_bits=20, version=0),
    dict(n=4, t_gsw=8, t_conv=4, t_exp_left=8, t_exp_right=56, q2_bits=20, version=0),
]


def get_params_from_store(num_items_log2: int, item_size_bytes: int) -> Params:
    """Pick a validated parameter set for a bucket of 2^num_items_log2 items
    of item_size_bytes each."""
    item_size = 1 << max(math.ceil(math.log2(max(item_size_bytes, 1))), 8)
    p = 256
    logp = 8
    for shape in BASE_SHAPES:
        n = shape["n"]
        # instances needed so each item fits: instances*n*n*poly_len*logp/8
        chunk_bytes = n * n * 2048 * logp // 8
        instances = max(1, math.ceil(item_size / chunk_bytes))
        # split num_items over (nu_1, nu_2): keep nu_1 ~ 9 as the reference
        nu_1 = min(9, max(2, num_items_log2 - 2))
        nu_2 = num_items_log2 - nu_1
        if nu_2 < 1:
            nu_1 = max(1, num_items_log2 - 1)
            nu_2 = num_items_log2 - nu_1
        obj = {
            "n": n, "nu_1": nu_1, "nu_2": nu_2, "p": p,
            "q2_bits": shape["q2_bits"], "t_gsw": shape["t_gsw"],
            "t_conv": shape["t_conv"], "t_exp_left": shape["t_exp_left"],
            "t_exp_right": shape["t_exp_right"], "instances": instances,
            "db_item_size": item_size, "version": shape["version"],
        }
        params = params_from_json_obj(obj)
        try:
            if estimate_log2_err_prob(params) <= P_ERR_GATE:
                return params
        except (AssertionError, ValueError):
            continue
    raise ValueError(
        f"no validated params for 2^{num_items_log2} x {item_size_bytes}B")
