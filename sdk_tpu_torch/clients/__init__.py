"""Client SDK of the port: the high-level Bucket API over the PIR protocol
(copied from sdk_tpu.clients, which mirrors the reference python SDK,
python/blyss/), and the SHA-1 bloom hashing that the checklist server
shares with its clients."""

from .bucket import Bucket
from .bucket_service import BucketService

__all__ = ["Bucket", "BucketService"]
