"""Client-side helpers of the port (ports sdk_tpu.clients); so far the
SHA-1 bloom hashing that the checklist server shares with its clients."""
