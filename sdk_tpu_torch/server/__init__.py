"""Bucket servers of the port: the Spiral key-value bucket (ports
sdk_tpu.server.kv_server) with its HTTP service (ports sdk_tpu.server.http)
and the DoublePIR checklist bucket with its HTTP handler (ports
sdk_tpu.server.doublepir_server)."""
