"""DoublePirClient: hint handling, batch query planning, serialization
(reference lib/doublepir/src/doublepir/client.rs)."""

from __future__ import annotations

import numpy as np

from . import scheme
from .database import DbInfo
from .matrix import SEEDS_SHORT, derive_from_seed
from .params import Params
from .serializer import (deserialize_state, deserialize_states,
                         serialize_state, serialize_states)


class DoublePirClient:
    def __init__(self, params: Params, info: DbInfo,
                 shared_state: list | None = None):
        self.params = params
        self.db_info = info
        self.shared_state = shared_state or scheme.init(info, params)
        self.hint: list = []

    @staticmethod
    def from_strings(params_str: str, dbinfo_str: str) -> "DoublePirClient":
        return DoublePirClient(Params.from_string(params_str),
                               DbInfo.from_string(dbinfo_str))

    def load_hint(self, hint_bytes: bytes) -> None:
        self.hint, _ = deserialize_state(hint_bytes)

    def generate_query(self, index: int,
                       rng: np.random.Generator | None = None) -> tuple[bytes, bytes]:
        """-> (serialized query msg, serialized client data [state, query])."""
        rng = rng or np.random.default_rng()
        state, msg = scheme.query(index, self.shared_state, self.params,
                                  self.db_info, rng)
        return serialize_state(msg), serialize_states([state, msg])

    def decode_response(self, response: bytes, index: int, query_index: int,
                        client_query_data: bytes) -> int:
        answer, _ = deserialize_state(response)
        qs = deserialize_states(client_query_data)
        assert len(qs) == 2
        client_state, query_msg = qs
        return scheme.recover(index, query_index, self.hint, query_msg,
                              answer, self.shared_state, client_state,
                              self.params, self.db_info)

    # --- batch planning (client.rs:174-283) ---

    def generate_query_plan(self, indices: list[int],
                            rng: np.random.Generator | None = None):
        """Partition DB rows into len(indices) batches; one query per batch;
        random filler index for empty batches. Returns (plan, target_indices)
        where plan[b] is (index, target) or None."""
        rng = rng or np.random.default_rng()
        params, info = self.params, self.db_info
        batch_num = len(indices)
        batch_sz = params.l // batch_num
        packing = max(info.packing, 1)
        batch_sz_words = batch_sz * params.m * packing
        plan: list = [None] * batch_num

        for i in indices:
            db_elem = i // packing
            row = db_elem // params.m
            batch = min(row // batch_sz, batch_num - 1)
            if plan[batch] is None:
                plan[batch] = (i, i)

        targets = []
        for b, entry in enumerate(plan):
            if entry is not None:
                targets.append(entry[1])
            else:
                rand_idx = int(rng.integers(0, batch_sz_words))
                targets.append(batch_sz_words * b + rand_idx)
        return plan, targets

    def generate_query_batch(self, indices: list[int],
                             rng: np.random.Generator | None = None):
        """-> (queries msg-states, client datas, plan)."""
        rng = rng or np.random.default_rng()
        plan, targets = self.generate_query_plan(indices, rng)
        queries, client_datas = [], []
        for t in targets:
            state, msg = scheme.query(t, self.shared_state, self.params,
                                      self.db_info, rng)
            queries.append(msg)
            client_datas.append(serialize_states([state, msg]))
        return queries, client_datas, plan
