"""Run one benchmark cell of the PyTorch port once on the GPU.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's system from the seed
(weights, inputs, the program's own set-up), warms up the shapes the cell
uses, measures for ``--seconds``, checks what the timed path produced
against the plain reference in ``port_bench/reference/``, and prints one
JSON line as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a profiled sub-window), ``device``,
``breakdown`` (traced runs) and ``checks``, each number compared beside its
limit, which are also the last lines of standard error.

It exits 3 without a result where CUDA is missing or has fewer devices than
the cell asks for, and 4 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, then the program at the checkout's root

from core import harness  # noqa: E402  (starts the set-up clock)


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        path = harness.BUILD / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    from core import registry

    bench = registry.benchmark()
    chips = int(registry.cell_entry(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    print(f"tf32 flags: torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", file=sys.stderr)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
