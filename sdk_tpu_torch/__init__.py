"""sdk_tpu_torch — the Spiral private-read path of sdk_tpu on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``sdk_tpu`` stays the reference; this package reuses its
jax-free host plane (params, client, poly, ntt_host, server_host, arith,
bitpack, rng, kv.key_value, kv.write, telemetry) by import and ports the
device plane:

- ``ops.ntt``      negacyclic NTT           (kernel group A, csrc/ntt.cu)
- ``ops.spiral``   server stages; matmul_mod (B, csrc/matmul_mod.cu) and
                   the first-dim scan        (C, csrc/scan.cu)
- ``ops.encode``   response rescale + pack  (D, csrc/encode.cu)
- ``ops.server``   SpiralServerTorch engine
- ``kv.ingest``    device ingest into the dense index
- ``server.kv_server``  SpiralKvServerTorch bucket

Tensors on a CUDA device run the kernels (built with nvcc on first use,
see ``_build``); tensors on the CPU run each kernel's plain PyTorch version.
This package never imports jax.
"""

__version__ = "0.1.0"
