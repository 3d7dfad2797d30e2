#!/usr/bin/env python3
"""A run of a cell with a fault planted under the timed path, to show that
``correct`` comes out false (pirbench/harness/faults.py). The benchmark's
own runs never plant one.

    python3 pirbench/control.py --workload <cell> --seed <n> --seconds <s> \
        --fault low_limb|stale_write|half_batch|altered [--cpu-tiny]

Prints the run's result line, as pirbench/run.py does; exits 0 when the
run came out not correct, 1 when it came out correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pirbench.harness.faults import FAULTS  # noqa: E402
from pirbench.run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--cpu-tiny", action="store_true")
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds, False,
                      cpu_tiny=args.cpu_tiny, fault=FAULTS[args.fault]())
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(dict(result, fault=args.fault)), flush=True)
    return 1 if result["correct"] else 0


if __name__ == "__main__":
    sys.exit(main())
