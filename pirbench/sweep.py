#!/usr/bin/env python3
"""Find the highest rate a configuration sustains under an open-loop mix:
one run a rate, each a fresh process on the card, the mix's rate_per_s
replaced by each offered rate in turn.

    python3 pirbench/sweep.py --config <config> --traffic <mix> \
        --rates 100,200,300 --seed <n> --seconds <s> [--cpu-tiny]

Each rate runs as a cell of its own in a copy of BENCHMARK.json and
pirbench/ under TMPDIR (nothing in the checkout changes). Prints a JSON
line a rate: offered and completed reads a second, the latencies, and
whether the run kept up (completed within 3% of offered). The benchmark's
runs do not use it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True,
                    help="offered requests a second, comma-separated")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "pirbench", "traffic",
                           f"{args.traffic}.json")) as f:
        base = json.load(f)
    if base.get("loop") != "open":
        raise SystemExit(f"{args.traffic} is not an open-loop mix")
    tmp = tempfile.mkdtemp(prefix="pirbench-sweep-")
    try:
        shutil.copytree(os.path.join(ROOT, "pirbench"),
                        os.path.join(tmp, "pirbench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for rate in args.rates.split(","):
            name = f"{args.traffic}-r{rate}"
            with open(os.path.join(tmp, "pirbench", "traffic",
                                   f"{name}.json"), "w") as f:
                json.dump(dict(base, rate_per_s=float(rate)), f)
            bench["workloads"].append({
                "name": f"{args.config}.{name}", "config": args.config,
                "traffic": name, "chips": 1, "why": "rate sweep"})
        with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        for rate in args.rates.split(","):
            cmd = [sys.executable, os.path.join(tmp, "pirbench", "run.py"),
                   "--workload", f"{args.config}.{args.traffic}-r{rate}",
                   "--seed", str(args.seed), "--seconds", str(args.seconds),
                   "--trace", "0"] + (["--cpu-tiny"] if args.cpu_tiny else [])
            res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, check=False)
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0 or not lines:
                print(json.dumps({"rate_per_s": float(rate),
                                  "rc": res.returncode,
                                  "stderr": res.stderr[-2000:]}), flush=True)
                continue
            out = json.loads(lines[-1])
            # the run logs every quantity it computes, its cell's or not
            m = {}
            for line in res.stderr.splitlines():
                parts = line.split()
                if len(parts) == 3 and parts[0] == "[pirbench]" and \
                        parts[1] in ("reads_per_s", "read_p50_ms",
                                     "read_p95_ms", "setup_s"):
                    m[parts[1]] = float(parts[2])
            offered = float(rate) * base["keys_per_request"]
            print(json.dumps({
                "rate_per_s": float(rate), "offered_reads_per_s": offered,
                **m, "kept_up": m["reads_per_s"] >= 0.97 * offered,
                "correct": out["correct"], "failed": out["failed"]}),
                flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
