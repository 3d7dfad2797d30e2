"""One load process: its clients' keys and /setup, their pregenerated
request pools, the loop over the window, and the judging of every answer.

It runs in a process of its own (multiprocessing, spawn) and imports the
frozen NumPy client only: no torch, no program. It talks to the run's
process through a pipe:

    -> ("keyed", seconds)            keys and queries made (while the
                                     bucket is being filled)
    <- ("serve", port, rows)         the service's port; the bytes of the
                                     rows this process asks for
    -> ("ready", seconds)            sessions set up, request bodies made
    <- ("go", t_start, t0, t1)       time.monotonic() instants, shared by
                                     every process of the machine
    -> ("done", results)             after the load and the judging

Closed loop: a thread a client keeps one request in flight and replays its
pool in turn. Open loop: requests fall due at the traffic's arrivals and
are handed to free senders; a request's latency counts from when it was
due. No request is sent at or after t1; the ones in flight then are
waited for and judged like the rest.

Every distinct response body of a pool entry is decoded with the client's
secret key (a body equal to one already judged has its verdict): the
server's answers are deterministic, so a sound run decodes each pool entry
once.
"""

from __future__ import annotations

import base64
import http.client
import json
import queue
import threading
import time
import traceback

import numpy as np

from ..reference.client import Client
from ..reference.judge import first_wrong_byte
from ..reference.params import params_from_json_obj
from ..reference.rng import ChaCha20Rng
from .traffic import Traffic, derive_seed, open_arrivals

REQUEST_TIMEOUT_S = 120.0
# distinct bodies kept a pool entry; a sound server gives one
MAX_DISTINCT = 16
# outcome codes of a request
RIGHT, WRONG, HTTP_ERROR, NO_ANSWER, UNJUDGED = range(5)


class Session:
    """One client: its keys, its uuid on the server, its pool."""

    def __init__(self, params, seed: int, spec: dict):
        c = spec["client"]
        self.client = Client(params)
        pp = self.client.generate_keys_from_seed(
            derive_seed(seed, "secret", c),
            noise_rng=ChaCha20Rng(derive_seed(seed, "key-noise", c)),
            pp_seed=derive_seed(seed, "public", c))
        self.setup_body = json.dumps(
            base64.b64encode(pp.serialize(params)).decode()).encode()
        self.spec = spec
        self.queries = [
            [self.client.generate_query(
                row, noise_rng=ChaCha20Rng(derive_seed(seed, "q-noise",
                                                       c, j, i)),
                query_seed=derive_seed(seed, "query", c, j, i)
             ).serialize(params) for i, row in enumerate(rows)]
            for j, rows in enumerate(spec["pool"])]
        self.bodies: list[bytes] = []
        # per pool entry: the distinct response bodies seen, then verdicts
        self.seen: list[list[bytes]] = [[] for _ in self.queries]
        self.verdicts: list[list[bool]] = []
        self.lock = threading.Lock()

    def make_bodies(self, uid: str) -> None:
        """The /private-read body of each pool entry: the session's uuid
        before each query, base64, in a JSON list."""
        self.bodies = [json.dumps([base64.b64encode(uid.encode() + q).decode()
                                   for q in qs]).encode()
                       for qs in self.queries]

    def classify(self, j: int, body: bytes) -> int:
        """Index of ``body`` among pool entry j's distinct bodies, or -1
        past MAX_DISTINCT."""
        seen = self.seen[j]
        if seen and body == seen[0]:
            return 0
        with self.lock:
            for k, b in enumerate(seen):
                if b == body:
                    return k
            if len(seen) >= MAX_DISTINCT:
                return -1
            seen.append(body)
            return len(seen) - 1


class Conn:
    """A keep-alive HTTP connection that reconnects after a failure."""

    def __init__(self, port: int):
        self.port = port
        self.http = None

    def post(self, path: str, body: bytes) -> tuple[int, bytes]:
        try:
            if self.http is None:
                self.http = http.client.HTTPConnection(
                    "localhost", self.port, timeout=REQUEST_TIMEOUT_S)
            self.http.request("POST", path, body, {
                "Content-Type": "application/json",
                "Content-Length": str(len(body))})
            resp = self.http.getresponse()
            return resp.status, resp.read()
        except (OSError, http.client.HTTPException):
            self.close()
            return -1, b""

    def close(self) -> None:
        if self.http is not None:
            self.http.close()
            self.http = None


class Records:
    """What happened to every request a process sent."""

    def __init__(self):
        self.lock = threading.Lock()
        self.rows: list[tuple] = []     # (t_sent, t_done, session, j, cls, status)
        self.max_lag_s = 0.0            # open loop: latest send after due

    def add(self, *row) -> None:
        with self.lock:
            self.rows.append(row)

    def note_lag(self, lag_s: float) -> None:
        with self.lock:
            self.max_lag_s = max(self.max_lag_s, lag_s)


def send_one(conn: Conn, sess: Session, j: int, t_sent: float,
             records: Records, s_idx: int) -> None:
    status, body = conn.post("/private-read", sess.bodies[j])
    t_done = time.monotonic()
    cls = sess.classify(j, body) if status == 200 else -1
    records.add(t_sent, t_done, s_idx, j, cls, status)


def closed_loop(port, sessions, traffic: Traffic, t_start, t1, records):
    def client(s_idx: int):
        sess, conn, j = sessions[s_idx], Conn(port), 0
        time.sleep(max(0.0, t_start - time.monotonic()))
        while True:
            t_sent = time.monotonic()
            if t_sent >= t1:
                break
            send_one(conn, sess, j % len(sess.bodies), t_sent, records, s_idx)
            j += 1
            if traffic.think_ms:
                time.sleep(traffic.think_ms / 1e3)
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(sessions))]
    return threads


def open_loop(port, sessions, traffic: Traffic, seed, process, t_start, t1,
              records):
    due = t_start + open_arrivals(traffic, seed, process, t1 - t_start)
    work: queue.Queue = queue.Queue()

    def scheduler():
        for k, t in enumerate(due):
            time.sleep(max(0.0, t - time.monotonic()))
            s_idx = k % len(sessions)
            j = (k // len(sessions)) % len(sessions[s_idx].bodies)
            work.put((t, s_idx, j))
        for _ in range(traffic.max_in_flight):
            work.put(None)

    def sender():
        conn = Conn(port)
        while (item := work.get()) is not None:
            t, s_idx, j = item
            records.note_lag(time.monotonic() - t)
            send_one(conn, sessions[s_idx], j, t, records, s_idx)
        conn.close()

    return ([threading.Thread(target=scheduler, daemon=True)]
            + [threading.Thread(target=sender, daemon=True)
               for _ in range(traffic.max_in_flight)])


def judge(sessions, rows: dict) -> list[str]:
    """Decode every distinct body; returns what was wrong, at most 8 lines."""
    wrong = []
    for sess in sessions:
        c = sess.spec["client"]
        for j, bodies in enumerate(sess.seen):
            want = sess.spec["pool"][j]
            verdicts = []
            for k, body in enumerate(bodies):
                ok, why = True, ""
                try:
                    answers = [base64.b64decode(a) for a in json.loads(body)]
                except (ValueError, TypeError) as e:
                    answers, why = [], f"malformed body: {e}"
                if len(answers) != len(want):
                    ok = False
                    why = why or f"{len(answers)} answers for {len(want)} keys"
                for i, (ans, row) in enumerate(zip(answers, want)):
                    if not ok:
                        break
                    try:
                        off = first_wrong_byte(sess.client, ans, rows[row])
                    except (ValueError, IndexError) as e:
                        off = f"nowhere: {e}"
                    if off is not None:
                        ok, why = False, (f"key {i} (row {row}) decodes "
                                          f"wrong from byte {off}")
                if not ok and len(wrong) < 8:
                    wrong.append(f"client {c} request {j} body {k}: {why}")
                verdicts.append(ok)
            sess.verdicts.append(verdicts)
    return wrong


def outcome(sess: Session, j: int, cls: int, status: int) -> int:
    if status == -1:
        return NO_ANSWER
    if status != 200:
        return HTTP_ERROR
    if cls < 0:
        return UNJUDGED
    return RIGHT if sess.verdicts[j][cls] else WRONG


def client_process(conn, spec: dict) -> None:
    try:
        _client_process(conn, spec)
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _client_process(conn, spec: dict) -> None:
    t = time.monotonic()
    params = params_from_json_obj(spec["params"])
    traffic = Traffic(**spec["traffic"])
    seed = spec["seed"]
    sessions = [Session(params, seed, c) for c in spec["clients"]]
    conn.send(("keyed", time.monotonic() - t))
    _, port, rows = conn.recv()
    t = time.monotonic()
    setup = Conn(port)
    for sess in sessions:
        status, body = setup.post("/setup", sess.setup_body)
        if status != 200:
            raise RuntimeError(f"/setup answered {status}: {body[:200]!r}")
        sess.make_bodies(json.loads(body)["uuid"])
    setup.close()
    conn.send(("ready", time.monotonic() - t))
    _, t_start, _t0, t1 = conn.recv()
    records = Records()
    if traffic.loop == "closed":
        threads = closed_loop(port, sessions, traffic, t_start, t1, records)
    else:
        threads = open_loop(port, sessions, traffic, seed, spec["process"],
                            t_start, t1, records)
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=max(0.0, t1 - time.monotonic()) + REQUEST_TIMEOUT_S
                + 10.0)
        if th.is_alive():
            raise RuntimeError("a sender did not finish")
    t_judge = time.monotonic()
    wrong = judge(sessions, rows)
    rec = records.rows
    out = {
        "t_sent": np.array([r[0] for r in rec]),
        "t_done": np.array([r[1] for r in rec]),
        "keys": np.array([len(sessions[r[2]].spec["pool"][r[3]])
                          for r in rec], dtype=np.int64),
        "outcome": np.array([outcome(sessions[r[2]], r[3], r[4], r[5])
                             for r in rec], dtype=np.int64),
        "decoded": sum(len(v) for s in sessions for v in s.seen),
        "judge_s": time.monotonic() - t_judge,
        "max_lag_s": records.max_lag_s,
        "wrong": wrong,
    }
    conn.send(("done", out))
