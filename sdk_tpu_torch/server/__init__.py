"""Bucket server state of the port (ports sdk_tpu.server.kv_server)."""
