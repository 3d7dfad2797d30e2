"""Device ingest of the port (ports sdk_tpu.kv.ingest)."""
