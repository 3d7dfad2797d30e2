"""High-level Bucket API (reference python/blyss/bucket.py, js Bucket).

All crypto is in-process (sdk_tpu_torch.client) — no native bridge needed; the
wire formats match the reference byte-for-byte, so this client also works
against the reference Rust server and vice versa.
"""

from __future__ import annotations

import base64
import bz2
import json
from typing import Any, Optional

from ..client import Client
from ..kv.key_value import extract_result, row_from_key
from ..params import Params, params_from_json_obj
from ..rng import ChaCha20Rng
from . import seed as seedmod
from .api import API

_MAX_PAYLOAD = 5 * 2 ** 20  # 5 MiB write chunks (bucket.py:66)


class Bucket:
    """Interface to a single PIR bucket."""

    def __init__(self, api: API, name: str = "",
                 secret_seed: Optional[str] = None):
        self.name = name
        self._api = api
        self._secret_seed = secret_seed or seedmod.get_random_seed()
        self._public_uuid: Optional[str] = None
        self._metadata = api.meta(name)
        scheme_obj = self._metadata["pir_scheme"]
        # scheme switch from /meta (reference bucket.ts:246-266)
        if scheme_obj.get("scheme") == "doublepir":
            self.scheme = "doublepir"
            self._init_doublepir(scheme_obj)
            return
        self.scheme = "spiral"
        self.params: Params = params_from_json_obj(scheme_obj)
        self._client = Client(self.params)
        self._client.generate_secret_keys_from_seed(
            seedmod.seed_from_string(self._secret_seed))
        self._pp_bytes: Optional[bytes] = None

    # --- DoublePIR (checklist) scheme ---

    def _init_doublepir(self, scheme_obj: dict) -> None:
        from ..doublepir.client import DoublePirClient
        from ..doublepir.database import DbInfo
        from ..doublepir.params import Params as DpParams

        self._dp_params = DpParams.from_string(scheme_obj["params"])
        self._dp_info = DbInfo.from_string(scheme_obj["dbinfo"])
        self._bloom_k = int(scheme_obj.get("bloom_k", 8))
        self._bloom_log2m = int(scheme_obj["bloom_log2m"])
        self._dp = DoublePirClient(self._dp_params, self._dp_info)
        self._dp_hint_loaded = False

    def _ensure_scheme(self, scheme: str):
        if self.scheme != scheme:
            raise RuntimeError(f"Cannot perform this action on a "
                               f"{self.scheme} bucket")

    def _load_dp_hint(self) -> None:
        if self._dp_hint_loaded:
            return
        scheme_obj = self._metadata["pir_scheme"]
        hint_bytes = int(scheme_obj.get("hint_bytes", 0))
        chunk_bytes = int(scheme_obj.get("hint_chunk_bytes", 0))
        if hint_bytes and chunk_bytes and hint_bytes > chunk_bytes:
            # chunked raw download (reference hint-CDN pattern,
            # bucket_service.ts:21-23): cacheable fixed-size pieces
            n = (hint_bytes + chunk_bytes - 1) // chunk_bytes
            parts = [self._api._get_raw(
                self._api._url(self.name, f"/hint/chunk/{i}"))
                for i in range(n)]
            self._dp.load_hint(b"".join(parts))
        else:
            r = self._api._get(self._api._url(self.name, "/hint"))
            self._dp.load_hint(base64.b64decode(r["hint"]))
        self._dp_hint_loaded = True

    def check_inclusion(self, key: str) -> bool:
        """Private membership check via batched DoublePIR bloom-bit reads
        (reference bucket.ts:202-232, 466-470): >= 5 of k bits set."""
        from .bloom import bloom_hash
        from ..doublepir.serializer import serialize_states

        self._ensure_scheme("doublepir")
        self._load_dp_hint()
        indices = [bloom_hash(key, i, self._bloom_log2m)
                   for i in range(self._bloom_k)]
        queries, client_datas, plan = self._dp.generate_query_batch(indices)
        body = serialize_states(queries)
        raw = self._api.private_read(self.name, [body])[0]
        count = 0
        for b, entry in enumerate(plan):
            if entry is None:
                continue
            idx = entry[0]
            bit = self._dp.decode_response(raw, idx, b, client_datas[b])
            if bit == 0:
                return False
            count += 1
        return count >= 5

    # --- scheme plumbing ---

    def get_row(self, key: str) -> int:
        return row_from_key(self.params.num_items(), key)

    def _generate_keys(self) -> bytes:
        pp = self._client.generate_keys_from_seed(
            seedmod.seed_from_string(self._secret_seed))
        return pp.serialize(self.params)

    def setup(self) -> None:
        """Generate + upload public params; stores the returned uuid
        (bucket.py:136-148)."""
        pp_bytes = self._generate_keys()
        self._pp_bytes = pp_bytes
        if self.params.expand_queries:
            self._public_uuid = self._api.setup(self.name, pp_bytes)
        else:
            self._public_uuid = "direct"

    def _check(self) -> bool:
        if self._public_uuid is None:
            return False
        if not self.params.expand_queries:
            return True
        return self._api.check(self._public_uuid)

    def _generate_query(self, row_idx: int) -> bytes:
        q = self._client.generate_query(row_idx).serialize(self.params)
        if self.params.expand_queries:
            assert self._public_uuid is not None
            return self._public_uuid.encode() + q
        assert self._pp_bytes is not None
        return self._pp_bytes + q

    def _decode_result_row(self, result_row: bytes,
                           silence_errors: bool = True) -> Optional[bytes]:
        from ..client import reframe_decoded_row

        try:
            decrypted = reframe_decoded_row(
                self.params, self._client.decode_response(result_row))
            dec = bz2.BZ2Decompressor()
            return dec.decompress(decrypted)   # tolerates zero padding
        except Exception:
            if not silence_errors:
                raise
            return None

    # --- public API (mirrors reference Bucket) ---

    def info(self) -> dict[str, Any]:
        return self._api.meta(self.name)

    def write(self, kv_pairs: dict[str, Optional[bytes]]) -> None:
        for chunk in self._split_into_json_chunks(kv_pairs):
            self._api.write(self.name, chunk)

    def delete_key(self, keys: str | list[str]) -> None:
        if isinstance(keys, str):
            keys = [keys]
        self._api.write(self.name, {k: None for k in keys})

    def private_read(self, keys: list[str]) -> list[Optional[bytes]]:
        rows = self.private_read_row([self.get_row(k) for k in keys])
        out = []
        for key, row in zip(keys, rows):
            if row is None:
                out.append(None)
                continue
            try:
                out.append(extract_result(key, row))
            except KeyError:
                out.append(None)
        return out

    def private_read_row(self, row_indices: list[int]) -> list[Optional[bytes]]:
        if not self._public_uuid or not self._check():
            self.setup()
        queries = [self._generate_query(i) for i in row_indices]
        raw = self._api.private_read(self.name, queries)
        return [self._decode_result_row(r) if r else None for r in raw]

    def private_key_intersect(self, keys: list[str]) -> list[str]:
        """Bloom-prefiltered private intersection (bucket.ts:413-432)."""
        from .bloom import BloomFilter

        r = self._api._get(self._api._url(self.name, "/bloom"))
        bf = BloomFilter.from_bytes(base64.b64decode(r["bloom"]))
        candidates = [k for k in keys if bf.lookup(k)]
        found = self.private_read(candidates)
        return [k for k, v in zip(candidates, found) if v is not None]

    def clear_entire_bucket(self) -> None:
        """Delete all keys; metadata, params, and client setup survive
        (reference bucket.py clear_entire_bucket)."""
        self._api._post(self._api._url(self.name, "/clear"), b"{}",
                        compress=False)

    def destroy_entire_bucket(self) -> None:
        """Destroy the bucket (the local single-bucket server maps this to
        /clear; the hosted service removes the bucket entirely)."""
        try:
            self._api._post(self._api._url(self.name, "/destroy"), b"",
                            compress=False)
        except Exception:
            self.clear_entire_bucket()

    def rename(self, new_name: str) -> None:
        self._api._post(self._api._url(self.name, "/modify"),
                        json.dumps({"name": new_name}).encode(),
                        compress=False)
        self.name = new_name

    def to_secret_seed(self) -> str:
        """Export this bucket identity as a 32-byte base64 seed
        (reference bucket.ts:483-486).

        Portable between this repo's Python and TypeScript clients ONLY:
        the Rust reference derives its ternary secret keys with a
        different shuffle draw order (client.rs:130-144), so a seed is
        NOT interchangeable with the Rust SDK (public wire formats are
        unaffected — see README "Compatibility")."""
        return self._secret_seed

    # --- write chunking (bucket.py:63-113) ---

    def _split_into_json_chunks(
            self, kv_pairs: dict[str, Optional[bytes]]) -> list[dict]:
        keys_by_index: dict[int, list[str]] = {}
        for k in kv_pairs:
            keys_by_index.setdefault(self.get_row(k), []).append(k)

        chunks: list[dict] = []
        current: dict = {}
        current_size = 0
        for i in sorted(keys_by_index):
            row = {}
            row_size = 0
            for key in keys_by_index[i]:
                vi = kv_pairs[key]
                v = base64.b64encode(vi).decode() if vi is not None else None
                row[key] = v
                row_size += 16 + len(key) + (len(v) if v is not None else 4)
            if current_size + row_size > _MAX_PAYLOAD and current:
                chunks.append(current)
                current, current_size = row, row_size
            else:
                current.update(row)
                current_size += row_size
        if current:
            chunks.append(current)
        return chunks
