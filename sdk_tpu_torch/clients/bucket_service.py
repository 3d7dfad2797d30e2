"""Service entry point: connect to buckets (reference
python/blyss/bucket_service.py, js BucketService)."""

from __future__ import annotations

from typing import Any, Optional, Union

from . import seed as seedmod
from .api import API
from .bucket import Bucket

DEFAULT_ENDPOINT = "https://beta.api.blyss.dev"


class BucketService:
    def __init__(self, api_key: str = "",
                 service_endpoint: str = DEFAULT_ENDPOINT):
        if isinstance(api_key, dict):
            cfg = api_key
            api_key = cfg.get("api_key", "")
            service_endpoint = cfg.get("endpoint", DEFAULT_ENDPOINT)
        self._api = API(api_key, service_endpoint)

    def connect(self, bucket_name: str = "",
                secret_seed: Optional[str] = None) -> Bucket:
        return Bucket(self._api, bucket_name, secret_seed)

    def exists(self, bucket_name: str = "") -> bool:
        return self._api.exists(bucket_name)

    def create(self, bucket_name: str, open_access: bool = False,
               usage_hints: Optional[dict[str, Any]] = None) -> None:
        hints = usage_hints or {}
        body = {"name": bucket_name, "open_access": open_access,
                "usage_hints": hints}
        import json as _json
        self._api._post(self._api.endpoint + "/create",
                        _json.dumps(body).encode(), compress=False)


def connect_local(port: int, secret_seed: Optional[str] = None) -> Bucket:
    """Connect to a local single-bucket server (the JS initializeLocal
    equivalent)."""
    return Bucket(API("", f"http://localhost:{port}"), "", secret_seed)
