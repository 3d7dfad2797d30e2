"""Key-value plane of the port (key_value, write: copied from sdk_tpu.kv)
and its device ingest (ingest: ports sdk_tpu.kv.ingest)."""
