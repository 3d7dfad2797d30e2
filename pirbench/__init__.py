"""The benchmark of sdk_tpu_torch: see pirbench/run.py."""
