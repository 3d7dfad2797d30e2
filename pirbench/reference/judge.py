"""Judge a /private-read answer: decode it with the client's secret key and
compare the row it carries with the bytes the benchmark wrote there."""

from __future__ import annotations

from .client import Client, reframe_decoded_row


def first_wrong_byte(client: Client, response: bytes, row: bytes) -> int | None:
    """None when ``response`` decodes to exactly ``row``; else the offset of
    the first byte that differs (the row's length when the decoded row is
    short)."""
    got = reframe_decoded_row(client.params, client.decode_response(response))
    if got[:len(row)] == row:
        return None
    for i, (a, b) in enumerate(zip(got, row)):
        if a != b:
            return i
    return min(len(got), len(row))
