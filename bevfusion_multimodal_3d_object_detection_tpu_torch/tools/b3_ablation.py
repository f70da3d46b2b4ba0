"""Kernel B3 (sorted BEV pool) on one card: the committed kernel beside
copies of it with one part taken out or changed, and beside other versions
of its source, in turns within one process.

    python3 -m bevfusion_multimodal_3d_object_detection_tpu_torch.tools.b3_ablation [other.cu ...]

from the repository root, on a machine with one CUDA card and `nvcc`. Each
`other.cu` is another version of ``csrc/bev_pool.cu`` (for example the
parent commit's, ``git show HEAD~1:<path> > build/parent.cu``; put such
files under ``build/``, which git ignores). The copies are made by editing
the committed source's text:

- ``half the loads in flight``: feature rows of 4 entries loaded together
  instead of 8 (two groups in flight: 4-8 KB a warp at C = 256 f32);
- ``one block a row``: 8 segments a row (48 warps at 6 rows) instead of a
  wave of the card's block slots;
- ``equal entries``: the row cut at equal shares of plan entries, pads
  counted as real ones, instead of the estimated cost;
- ``no combine``: a cell cut between blocks is stored with the sums of its
  first block only, the later blocks' dropped, so this copy disagrees by
  design;
- ``no walk``: every segment empty: the probes, the cut, and the combine
  kernel zeroing the whole output (disagrees);
- ``no combine kernel``: the sorted kernel alone (cut cells and the gaps
  between segments are left unwritten: disagrees).

Each version is built into ``build/b3_ablation/`` (one nvcc each, in
parallel, with ``--resource-usage``) and run on f32 per-point features
(C = 256, seeded) over plans of the 6-camera ring calibration
(``chip_smoke.ring_camera_cells``, 40 depth bins, 28x50 pixels, 50x50
cells) at 6 rows (phase 8's shape) and 48 rows, and over 6 rows whose
longest cell holds 30,000 entries (``chip_smoke.long_cell_cells``); then
B2's fallback for rows too long for shared memory: 6 rows of 16,384 pixels,
bf16, C = 256, 4 depth bins, random cells over 50x50 (B2 launches the
sorted kernel there; an earlier version, its own fallback). Each is
compared with the plain version (1e-5 of the terms' magnitudes, as phase 6)
and with the committed kernel's output bit for bit; the committed kernel
also with a second launch of itself, and its split is read back
(`bev_pool.sorted_segments`: real entries of the busiest warp against its
row's mean). Then each is timed twice in turns (forward order, then
reverse, after an untimed warm-up pass over all): the device time alone,
by CUDA-graph replay. Prints one line per run and, last, a JSON object of
the medians.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import bev_pool as bp
from .b2_ablation import ROOT, build_versions

OUT = ROOT / "build" / "b3_ablation"
ABLATIONS = {  # name: [(text of the committed source, its replacement)]
    "half the loads in flight": [("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")],
    "one block a row": [("constexpr int kMaxRowBlocks = 128;", "constexpr int kMaxRowBlocks = 1;")],
    "equal entries": [("constexpr int kRealCost = 4;", "constexpr int kRealCost = 1;")],
    "no combine": [("for (int b = x + 1; b < stop; b += kPartsAhead) {", "for (int b = stop; b < stop; b += kPartsAhead) {")],
    "no walk": [("const int begin = cut(s), end = cut(s + 1);", "const int begin = cut(s), end = begin;")],
    "no combine kernel": [
        ("  combine_kernel<T, U><<<grid, 32 * kPoolWarps, 0, stream>>>(partial, ends, plan.num_cells, channels, o);\n",
         "")],
}


def _sources(others) -> dict:
    src = (_build.CSRC / _build.SOURCES["bev_pool"]).read_text()
    out = {"committed": src}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"ablation {name!r}: the source no longer contains {old!r}")
            text = text.replace(old, new)
        out[name] = text
    for path in others:
        out[Path(path).name] = Path(path).read_text()
    return out


def _case(cs, kind: str, rows: int, g: torch.Generator) -> tuple:
    """The pool of a case as a function of nothing, its plain version's
    output and terms' magnitudes, and the committed kernel's launch config.
    B3: per-point f32 features (rows, 56000, 256) on ring or long-cell
    plans; B2's fallback: bf16 features of 16,384 pixels (C = 256) and
    softmax weights over 4 depth bins, 30 % of the points out of range."""
    if kind == "B2 fallback":
        cells = np.random.RandomState(13).randint(-1, 2500, (rows, 4, 16384)).astype(np.int32)
        cells[np.random.RandomState(14).rand(*cells.shape) < 0.3] = -1
        plan = cs.device_plan(cells, 2500)
        feats = torch.randn(rows, 16384, 256, device="cuda", generator=g).bfloat16()
        weights = torch.softmax(torch.randn(rows, 4, 16384, device="cuda", generator=g), dim=1).reshape(rows, -1)
        if bp.weighted_config(feats, plan[0].shape[1])["slice_channels"]:
            raise SystemExit("rows of 16,384 pixels must take the sorted kernel")
        ref = lambda x: bp.bev_pool_weighted_reference(x, weights, *plan, 2500, 2560)
        return (lambda: bp.bev_pool_weighted_rows(feats, weights, *plan, 2500, 2560), ref(feats), ref(feats.abs()),
                lambda: bp.sorted_config(feats, *plan[0].shape[1:]))
    if kind == "ring":
        pc_range = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
        cells = np.tile(cs.ring_camera_cells((448, 800), (50, 50), 40, 1.0, 60.0, pc_range), (rows // 6, 1, 1, 1))
    else:
        cells = cs.long_cell_cells(rows, 40, 1400, 2500)
    plan = cs.device_plan(cells, 2500)
    feats = torch.randn(rows, 56000, 256, device="cuda", generator=g)
    ref = lambda x: bp.bev_pool_sorted_reference(x, *plan, 2500, 2560)

    def config():
        real = bp.sorted_segments(feats, *plan, 2500).float()
        return {**bp.sorted_config(feats, *plan[0].shape[1:]),
                "busiest_warp_share": float((real.amax(1) / real.mean(1)).max())}

    return lambda: bp.bev_pool_rows(feats, *plan, 2500, 2560), ref(feats), ref(feats.abs()), config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("others", nargs="*", help="other versions of csrc/bev_pool.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("b3_ablation: no CUDA device", file=sys.stderr)
        return 1
    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)

    libs = build_versions(_sources(args.others), OUT)
    current = ["committed"]
    _build.load = lambda name, declare: libs[current[0]]  # the wrapper launches `current`
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(12)
    order = list(libs) + list(libs)[::-1]
    results, configs = {}, {}
    for kind, rows in (("ring", 6), ("ring", 48), ("long cell", 6), ("B2 fallback", 6)):
        shape = (f"{rows}x16384x256 bf16 B2 fallback (D = 4)" if kind == "B2 fallback"
                 else f"{rows}x56000x256 f32 {kind}")
        pool, want, scale, config = _case(cs, kind, rows, g)
        current[0] = "committed"
        configs[shape] = config = config()
        committed = pool()
        again = pool()
        print(f"{shape} committed: {config}, two launches bit-identical: {torch.equal(committed, again)}",
              flush=True)
        for name in libs:  # a warm-up pass, so that the first version timed finds the clocks up
            current[0] = name
            cs.graph_ms(pool, 5)
        for name in order:
            current[0] = name
            got = pool()
            s = cs.compare(got, want, torch.float32, scale)
            dev = cs.graph_ms(pool)
            results.setdefault(shape, {}).setdefault(name, []).append(dev)
            print(f"{shape} {name}: device {dev:.4f} ms, worst {s['worst']:.3g} of the limit "
                  f"(agrees: {s['worst'] <= 1.0}), bit-identical to the committed kernel: "
                  f"{torch.equal(got, committed)}", flush=True)
        del pool, want, scale, committed, again
        torch.cuda.empty_cache()
    summary = {shape: {name: float(np.median(runs)) for name, runs in per.items()}
               for shape, per in results.items()}
    print(json.dumps({"device_ms": summary, "committed_config": configs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
