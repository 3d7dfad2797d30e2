"""sdk_tpu_torch — the Spiral private-read path and the DoublePIR checklist
of sdk_tpu on PyTorch and hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``sdk_tpu`` stays the reference. This package has no
runtime dependency on it: it carries its own copy of the numpy host plane
(``params``, ``params_store``, ``client``, ``poly``, ``ntt_host``,
``arith``, ``bitpack``, ``rng``, ``discrete_gaussian``, ``noise_estimate``,
``kv.key_value``, ``kv.write``, and the jax-free parts of ``telemetry`` and
``debug_hooks``) and ports the device plane:

- ``ops.ntt``      negacyclic NTT           (kernel group A, csrc/ntt.cu)
- ``ops.spiral``   server stages; matmul_mod (B, csrc/matmul_mod.cu), the
                   dense first-dim scan      (C, csrc/scan.cu), the compact
                   scan                      (I, csrc/scan_compact.cu), the
                   batched expansion round   (E, csrc/expansion.cu) over
                   the dense and the sparse (J) schedule, and the round's
                   former elementwise body   (E', csrc/expand_round.cu)
- ``ops.encode``   response rescale + pack  (D, csrc/encode.cu)
- ``ops.server``   SpiralServerTorch engine
- ``kv.ingest``    device ingest into the compact or dense index, migration
- ``server.kv_server``  SpiralKvServerTorch bucket (compact -> dense
                   lifecycle)
- ``doublepir``    DoublePIR: a copy of the numpy host plane, ``kernels``
                   (wrapping u32 products, L, csrc/dp_matmul_u32.cu) and
                   ``server_torch`` (ChecklistServerTorch; int8 DB products,
                   K, csrc/dp_dot_i8.cu)
- ``server.doublepir_server``  DoublePirKvServerTorch checklist bucket and
                   its HTTP handler

Tensors on a CUDA device run the kernels (built with nvcc on first use,
see ``_build``); tensors on the CPU run each kernel's plain PyTorch version.
This package never imports jax.
"""

__version__ = "0.1.0"
