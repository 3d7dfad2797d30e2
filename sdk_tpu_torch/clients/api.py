"""HTTP API client (stdlib urllib; sync) — the transport layer under Bucket
(reference python/blyss/api.py, js/client/api.ts).

Supports both URL shapes:
  - local single-bucket server (bare paths /meta, /setup, ... — the shape of
    the reference's Rust server and our sdk_tpu_torch.server.http), and
  - hosted multi-bucket service (/<bucket>/meta etc.) when a bucket name is
    given.
"""

from __future__ import annotations

import gzip
import json
import urllib.error
import urllib.request
from typing import Any, Optional

META_PATH = "/meta"
SETUP_PATH = "/setup"
WRITE_PATH = "/write"
READ_PATH = "/private-read"
CHECK_PATH = "/check"
BLOOM_PATH = "/bloom"

# bodies above this go via the presigned-upload flow instead of inline JSON
# (APIGW 6 MB limit, base64 factor + 5% margin — reference python/blyss/api.py:32)
APIGW_MAX_SIZE = int(6e6 / (4 / 3) * 0.95)


class ApiError(Exception):
    def __init__(self, message: str, code: int):
        super().__init__(f"API error {code}: {message}")
        self.code = code


class API:
    def __init__(self, api_key: str = "", service_endpoint: str = ""):
        self.api_key = api_key
        self.endpoint = service_endpoint.rstrip("/")

    # --- low-level ---

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.api_key:
            h["x-api-key"] = self.api_key
        return h

    def _get(self, url: str) -> Any:
        return json.loads(self._get_raw(url))

    def _get_raw(self, url: str) -> bytes:
        req = urllib.request.Request(url, headers=self._headers())
        try:
            with urllib.request.urlopen(req) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise ApiError(e.read().decode(errors="replace"), e.code) from None

    def _post(self, url: str, data: bytes, compress: bool = True) -> Any:
        headers = self._headers()
        if compress and len(data) > 1024:
            data = gzip.compress(data)
            headers["Content-Encoding"] = "gzip"
        req = urllib.request.Request(url, data=data, headers=headers)
        try:
            with urllib.request.urlopen(req) as r:
                body = r.read()
                return json.loads(body) if body else None
        except urllib.error.HTTPError as e:
            raise ApiError(e.read().decode(errors="replace"), e.code) from None

    def _url(self, bucket_name: str, path: str) -> str:
        if bucket_name:
            return f"{self.endpoint}/{bucket_name}{path}"
        return self.endpoint + path

    # --- routes ---

    def meta(self, bucket_name: str = "") -> dict:
        return self._get(self._url(bucket_name, META_PATH))

    def exists(self, bucket_name: str = "") -> bool:
        try:
            self.meta(bucket_name)
            return True
        except (ApiError, urllib.error.URLError):
            return False

    def check(self, uuid: str) -> bool:
        try:
            r = self._get(f"{self.endpoint}/{uuid}{CHECK_PATH}")
            return bool(r.get("found", True))
        except ApiError:
            return False

    def _post_form_data(self, url: str, fields: dict, data: bytes) -> None:
        """multipart/form-data POST — the presigned-upload payload leg
        (reference js/client/api.ts:150-178 postFormData)."""
        import uuid as _uuid

        boundary = "----sdktpu" + _uuid.uuid4().hex
        parts = []
        for k, v in fields.items():
            parts.append(
                (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n{v}\r\n').encode())
        parts.append(
            (f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="file"; filename="file"\r\n'
             f"Content-Type: application/octet-stream\r\n\r\n").encode())
        body = b"".join(parts) + data + f"\r\n--{boundary}--\r\n".encode()
        headers = self._headers()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
        req = urllib.request.Request(url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req) as r:
                r.read()
        except urllib.error.HTTPError as e:
            raise ApiError(e.read().decode(errors="replace"), e.code) from None

    def setup_presigned(self, bucket_name: str, data: bytes) -> str:
        """Large-payload setup: prelim {"length": N} -> presigned URL ->
        multipart upload (reference api.rs:149-186, js api.ts:303-324)."""
        body = json.dumps({"length": len(data)}).encode()
        r = self._post(self._url(bucket_name, SETUP_PATH), body,
                       compress=False)
        url = r["url"]
        if url.startswith("/"):   # local emulation returns a relative slot
            url = self.endpoint + url
        self._post_form_data(url, r.get("fields", {}), data)
        return r["uuid"]

    def setup(self, bucket_name: str, data: bytes) -> str:
        import base64

        if len(data) > APIGW_MAX_SIZE:
            return self.setup_presigned(bucket_name, data)
        body = json.dumps(base64.b64encode(data).decode()).encode()
        r = self._post(self._url(bucket_name, SETUP_PATH), body, compress=False)
        return r["uuid"]

    def write(self, bucket_name: str, kv_json: dict) -> Any:
        return self._post(self._url(bucket_name, WRITE_PATH),
                          json.dumps(kv_json).encode())

    def private_read(self, bucket_name: str, queries: list[bytes]) -> list[Optional[bytes]]:
        import base64

        body = json.dumps([base64.b64encode(q).decode() for q in queries]).encode()
        r = self._post(self._url(bucket_name, READ_PATH), body, compress=False)
        return [base64.b64decode(x) if x else None for x in r]
