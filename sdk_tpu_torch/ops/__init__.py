"""Device compute plane of the port (ports sdk_tpu.ops)."""
