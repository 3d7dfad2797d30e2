"""CUDA C++ sources of the port's kernels (built by sdk_tpu_torch._build)."""
