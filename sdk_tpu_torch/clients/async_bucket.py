"""AsyncBucket: async variant of Bucket with bounded write concurrency
(reference python/blyss/bucket.py AsyncBucket, semaphore <= 8 concurrent
write chunks, bucket.py:318-342)."""

from __future__ import annotations

import asyncio
import base64
import json
from typing import Any, Optional

from .bucket import Bucket
from .api import API, ApiError

_MAX_CONCURRENCY = 8


class AsyncBucket(Bucket):
    """Bucket with async write/read entry points. Crypto stays in-process;
    only the HTTP I/O is async."""

    async def async_write(self, kv_pairs: dict[str, Optional[bytes]]) -> None:
        chunks = self._split_into_json_chunks(kv_pairs)
        import httpx   # imported at use: the package imports without it

        sem = asyncio.Semaphore(_MAX_CONCURRENCY)
        async with httpx.AsyncClient(timeout=600) as client:

            async def post(chunk):
                async with sem:
                    url = self._api._url(self.name, "/write")
                    r = await client.post(url, content=json.dumps(chunk).encode(),
                                          headers={"Content-Type": "application/json"})
                    if r.status_code != 200:
                        raise ApiError(r.text, r.status_code)

            await asyncio.gather(*(post(c) for c in chunks))

    async def async_private_read(self, keys: list[str]) -> list[Optional[bytes]]:
        # query generation and decoding are CPU-bound; run off the loop
        return await asyncio.to_thread(self.private_read, keys)

    async def async_delete_key(self, keys: str | list[str]) -> None:
        if isinstance(keys, str):
            keys = [keys]
        await self.async_write({k: None for k in keys})
