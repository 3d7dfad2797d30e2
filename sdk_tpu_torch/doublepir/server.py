"""DoublePirServer: preprocessing, serving, and checkpoint/restore of the
preprocessed index (reference lib/doublepir/src/doublepir/server.rs).

File set for save/restore (server.rs:50-59):
  <base>.hint    client hint (State)
  <base>.state   server state (State: squished H1, A2^T)
  <base>.dbp     raw squished DB matrix values (native-endian u32)
  <base>.dbinfo  DbInfo (8-byte BE fields)
  <base>.params  params CSV string
  <base>.txt     "rows,cols" of the DB matrix
"""

from __future__ import annotations

import os

import numpy as np

from . import scheme
from .database import Db, DbInfo
from .params import LOGQ, SEC_PARAM, Params, pick_params
from .serializer import (deserialize_dbinfo, deserialize_state,
                         deserialize_states, serialize_dbinfo,
                         serialize_state, serialize_states)

U32 = np.uint32


class DoublePirServer:
    def __init__(self, num_entries: int, bits_per_entry: int,
                 params: Params | None = None):
        self.num_entries = num_entries
        self.bits_per_entry = bits_per_entry
        self.params = params or pick_params(num_entries, bits_per_entry,
                                            SEC_PARAM, LOGQ)
        self.db = Db(DbInfo.new(num_entries, bits_per_entry, self.params),
                     np.zeros((0, 0), dtype=U32))
        self.shared_state = scheme.init(self.db.info, self.params)
        self.server_state: list = []
        self.hint: list = []
        self.adjustments = self.generate_adjustments(self.params,
                                                     self.shared_state)

    @staticmethod
    def generate_adjustments(params: Params, shared_state: list) -> np.ndarray:
        """Per-column hint corrections for the DB recentering
        (server.rs:182-198)."""
        q = 1 << params.logq
        ratio = params.p // 2
        a_2 = shared_state[1]
        sums = (np.uint64(ratio) * a_2.astype(np.uint64)).sum(axis=0) % np.uint64(q)
        return ((q - sums.astype(np.int64)) % q).astype(U32)

    def load_data(self, entries, matmul_u32_fn=None) -> None:
        self.db = Db.from_entries(self.num_entries, self.bits_per_entry,
                                  self.params, entries)
        self.server_state, self.hint = scheme.setup(
            self.db, self.shared_state, self.params, matmul_u32_fn)

    def get_hint(self) -> bytes:
        return serialize_state(self.hint)

    def answer(self, query_bytes: bytes) -> bytes:
        queries = deserialize_states(query_bytes)
        resp = scheme.answer(self.db, queries, self.server_state, self.params)
        return serialize_state(resp)

    def answer_inline(self, query_bytes: bytes, data: np.ndarray,
                      chunk_idx: int | None) -> bytes:
        """Chunked serving: answer over one row-chunk of the DB
        (server.rs:167-180)."""
        queries = deserialize_states(query_bytes)
        resp = scheme.answer(self.db, queries, self.server_state, self.params,
                             raw_data=data, chunk_idx=chunk_idx)
        return serialize_state(resp)

    # --- checkpoint / restore of the preprocessed index ---

    @staticmethod
    def file_names(base: str):
        return (f"{base}.hint", f"{base}.state", f"{base}.dbp",
                f"{base}.dbinfo", f"{base}.params", f"{base}.txt")

    def save_to_files(self, base: str) -> None:
        hintf, statef, dbf, infof, paramsf, txtf = self.file_names(base)
        with open(hintf, "wb") as f:
            f.write(serialize_state(self.hint))
        with open(statef, "wb") as f:
            f.write(serialize_state(self.server_state))
        with open(infof, "wb") as f:
            f.write(serialize_dbinfo(self.db.info))
        with open(paramsf, "w") as f:
            f.write(self.params.to_string())
        with open(dbf, "wb") as f:
            f.write(self.db.data.astype("<u4").tobytes())
        with open(txtf, "w") as f:
            f.write(f"{self.db.data.shape[0]},{self.db.data.shape[1]}")

    def restore_from_files(self, base: str, load_server_state: bool = True,
                           load_db_data: bool = True) -> None:
        hintf, statef, dbf, infof, _paramsf, txtf = self.file_names(base)
        with open(hintf, "rb") as f:
            self.hint, _ = deserialize_state(f.read())
        if load_server_state:
            with open(statef, "rb") as f:
                self.server_state, _ = deserialize_state(f.read())
        with open(infof, "rb") as f:
            info = deserialize_dbinfo(f.read())
        with open(txtf) as f:
            rows, cols = (int(x) for x in f.read().split(","))
        data = np.zeros((rows, cols), dtype=U32)
        if load_db_data:
            raw = np.fromfile(dbf, dtype="<u4")
            data = raw.reshape(rows, cols).astype(U32)
        self.db = Db(info, data)
