"""DoublePIR wire/persistence serialization, byte-compatible with the
reference (lib/doublepir/src/serializer/serializer.rs).

Matrix: u32-BE rows, u32-BE cols, then u32-BE values row-major.
State (list of matrices): u32-BE count, then each matrix.
Vec<State>: u32-BE count, then each State.
DbInfo: u64/usize fields as 8-byte BE (serializer.rs:126-169).
"""

from __future__ import annotations

import struct

import numpy as np

from .database import DbInfo

U32 = np.uint32
MAX_LEN = 1 << 28


def serialize_matrix(m: np.ndarray) -> bytes:
    rows, cols = m.shape
    head = struct.pack(">II", rows, cols)
    return head + m.astype(">u4").tobytes()


def deserialize_matrix(data: bytes, offs: int = 0) -> tuple[np.ndarray, int]:
    rows, cols = struct.unpack_from(">II", data, offs)
    assert rows < MAX_LEN and cols < MAX_LEN
    offs += 8
    n = rows * cols * 4
    m = np.frombuffer(data[offs : offs + n], dtype=">u4").astype(U32)
    return m.reshape(rows, cols), offs + n


def serialize_state(state: list[np.ndarray]) -> bytes:
    out = bytearray(struct.pack(">I", len(state)))
    for m in state:
        out.extend(serialize_matrix(m))
    return bytes(out)


def deserialize_state(data: bytes, offs: int = 0) -> tuple[list, int]:
    (count,) = struct.unpack_from(">I", data, offs)
    assert count < MAX_LEN
    offs += 4
    out = []
    for _ in range(count):
        m, offs = deserialize_matrix(data, offs)
        out.append(m)
    return out, offs


def serialize_states(states: list[list[np.ndarray]]) -> bytes:
    out = bytearray(struct.pack(">I", len(states)))
    for s in states:
        out.extend(serialize_state(s))
    return bytes(out)


def deserialize_states(data: bytes) -> list[list[np.ndarray]]:
    (count,) = struct.unpack_from(">I", data, 0)
    offs = 4
    out = []
    for _ in range(count):
        s, offs = deserialize_state(data, offs)
        out.append(s)
    return out


def serialize_dbinfo(info: DbInfo) -> bytes:
    return struct.pack(
        ">QQQQQQQQQQ", info.num_entries, info.bits_per_entry, info.packing,
        info.ne, info.x, info.p, info.logq, info.squish_basis,
        info.squish_delta, info.orig_cols)


def deserialize_dbinfo(data: bytes) -> DbInfo:
    v = struct.unpack_from(">QQQQQQQQQQ", data, 0)
    return DbInfo(num_entries=v[0], bits_per_entry=v[1], packing=v[2],
                  ne=v[3], x=v[4], p=v[5], logq=v[6], squish_basis=v[7],
                  squish_delta=v[8], orig_cols=v[9])
