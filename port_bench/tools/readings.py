"""Readings that set a cell's limits, on the GPU, in one process.

    python3 port_bench/tools/readings.py --workload <cell> --seeds 12 [--control 3]
        [--fault half_batch:3 ...] [--seconds 3] [--first-seed N] [--out file.json]

For each of `--seeds` seeds it runs the cell through the timed path at its
own size (a short window of `--seconds` at the cell's load) and records the
numbers that decide `correct`; then the control (the reference in the next
lower precision, or the program's own lower-precision path, in the
program's place) on `--control` seeds, and each `--fault NAME:N` on N seeds.
The lower reading of a number is its largest over the program's seeds; the
upper the smallest over the control's (or a fault's). Prints one JSON line
a run and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from core import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    plan = [((), args.seeds), (("control",), args.control)]
    plan += [((name,), int(n)) for name, n in (f.split(":") for f in args.fault)]
    rows = []
    seed = args.first_seed
    for faults, n in plan:
        for _ in range(n):
            seed += 7919
            t = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", faults=faults)
            row = {"faults": list(faults), "seed": seed, "checks": {k: v["value"] for k, v in r["checks"].items()},
                   "metrics": {k: v["value"] for k, v in r["metrics"].items()}, "s": time.perf_counter() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["checks"]:
        prog = [r["checks"][name] for r in rows if not r["faults"]]
        summary[name] = {"lower": max(prog),
                         **{"+".join(f) or "program": min(r["checks"][name] for r in rows if r["faults"] == list(f))
                            for f, _ in plan[1:]}}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
