"""The highest Poisson rate a serving cell sustains, by a sweep on the GPU.

    python3 port_bench/tools/sweep.py --workload serve_base_poisson --rates 150,200,250 [--seconds 10]

For each offered rate, one window of `--seconds` in one process: the rate
completed inside the window and the median latency of the window's first
and second halves. A rate is sustained when completions are within 2 % of
the offered rate and the second half's median latency is under 1.5 times
the first half's (the backlog does not grow).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from core import harness, registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5_000_000_000)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    wl, entry = registry.workload(args.workload), registry.cell_entry(bench, args.workload)
    cfg = registry.config(bench, entry["config"])
    drv = registry.driver(wl["driver"])
    for rate in (float(r) for r in args.rates.split(",")):
        wl["traffic"]["rate"] = rate
        ctx = harness.Context(args.workload, wl, cfg, args.seed, args.seconds, False, torch.device("cuda:0"))
        out = drv.run(ctx)
        lat = out.layer_data["latencies_ms"]
        half = len(lat) // 2
        first, second = float(np.median(lat[:half])), float(np.median(lat[half:]))
        done = out.e2e["serve_samples_per_s"]
        row = {"rate": rate, "completed_per_s": done, "p95_ms": out.e2e["serve_p95_ms"],
               "median_first_half_ms": first, "median_second_half_ms": second, "failed": out.failed,
               "sustained": bool(done >= 0.98 * rate and second < 1.5 * first and out.failed == 0)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
