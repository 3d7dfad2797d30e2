"""The one traffic generator: a traffic file's parameters and the seed give
each load process its clients, their sessions' seeds and the rows of every
request in their pools.

A traffic file (``pirbench/traffic/<mix>.json``) holds:

    loop              "closed": each client sends its next request when the
                      last one has come back (after ``think_ms``); "open":
                      requests are due at Poisson arrivals of ``rate_per_s``
                      over all processes, whatever came back, the same
                      number in every run
    clients           sessions, each with its own keys and one /setup
    processes         load processes the clients are spread over
    keys_per_request  distinct rows a /private-read request asks for
    think_ms          closed loop: pause between a response and the next send
    rows              "uniform": every row of the bucket equally likely;
                      "written": every row the configuration's fill
                      writes equally likely (service.written_rows)
    pool_per_client   pregenerated requests a client replays in turn
    ramp_s            load before the measured window starts (set-up)
    rate_per_s        open loop only: the offered requests per second
    max_in_flight     open loop only: senders a process holds
    assumed           what the mix assumes, in words (not read)

Keys are never a function of anything but the seed, so two runs with one
seed send the same requests in the same order per client.
"""

from __future__ import annotations

import hashlib
import json
from collections.abc import Sequence
from dataclasses import dataclass, fields

import numpy as np

LOOPS = ("closed", "open")
ROWS = ("uniform", "written")


@dataclass(frozen=True)
class Traffic:
    name: str
    loop: str
    clients: int
    processes: int
    keys_per_request: int
    think_ms: float
    rows: str
    pool_per_client: int
    ramp_s: float
    rate_per_s: float = 0.0
    max_in_flight: int = 0


def load_traffic(path: str, name: str) -> Traffic:
    with open(path) as f:
        raw = json.load(f)
    known = {f.name for f in fields(Traffic)} - {"name"}
    extra = set(raw) - known - {"assumed", "why"}
    if extra:
        raise ValueError(f"traffic {name}: unknown keys {sorted(extra)}")
    t = Traffic(name=name, **{k: v for k, v in raw.items() if k in known})
    if t.loop not in LOOPS or t.rows not in ROWS:
        raise ValueError(f"traffic {name}: loop {t.loop!r}, rows {t.rows!r}")
    if min(t.clients, t.processes, t.keys_per_request, t.pool_per_client) < 1:
        raise ValueError(f"traffic {name}: counts must be at least 1")
    if t.processes > t.clients:
        raise ValueError(f"traffic {name}: more processes than clients")
    if t.loop == "open" and (t.rate_per_s <= 0 or t.max_in_flight < 1):
        raise ValueError(f"traffic {name}: an open loop needs rate_per_s "
                         f"and max_in_flight")
    return t


def derive_seed(seed: int, *parts) -> bytes:
    """32 bytes for one purpose (keys, noise, a query) of one run."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return hashlib.sha256(text.encode()).digest()


def plan(traffic: Traffic, seed: int,
         rows: Sequence[int]) -> list[list[dict]]:
    """Per load process, its clients: ``{"client": c, "pool": [[row, ...],
    ...]}``, each request's distinct rows drawn uniformly from ``rows``:
    every row of the bucket (``range``) for "uniform", the written rows for
    "written". Clients are dealt round-robin over the processes."""
    if traffic.keys_per_request > len(rows):
        raise ValueError(f"{traffic.keys_per_request} keys a request, "
                         f"{len(rows)} rows to draw from")
    pop = np.asarray(rows)
    gen = np.random.default_rng([seed, 0x726F7773])
    procs: list[list[dict]] = [[] for _ in range(traffic.processes)]
    for c in range(traffic.clients):
        pool = [sorted(int(r) for r in gen.choice(
                    pop, traffic.keys_per_request, replace=False))
                for _ in range(traffic.pool_per_client)]
        procs[c % traffic.processes].append({"client": c, "pool": pool})
    return procs


def open_arrivals(traffic: Traffic, seed: int, process: int,
                  duration_s: float) -> np.ndarray:
    """Seconds after the load starts at which this process's requests are
    due: rate_per_s / processes a second over ``duration_s``, at gaps drawn
    once from an exponential distribution (Poisson arrivals) and scaled to
    fill the duration exactly. Every seed gets the same gaps in another
    order, so every run offers the same number of requests."""
    n = max(1, round(traffic.rate_per_s / traffic.processes * duration_s))
    gaps = np.random.default_rng([0x6F70656E, process]).exponential(1.0, n)
    gaps *= duration_s / gaps.sum()
    order = np.random.default_rng([seed, 0x6F70656E, process]).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order[0]]
