"""Kernel B2 (weighted BEV pool) on one card: the committed kernel beside
copies of it with one part taken out or changed, and beside other versions
of its source, in turns within one process.

    python3 -m bevfusion_multimodal_3d_object_detection_tpu_torch.tools.b2_ablation [other.cu ...]

from the repository root, on a machine with one CUDA card and `nvcc`. Each
`other.cu` is another version of ``csrc/bev_pool.cu`` with the same
``bev_pool_forward`` (for example the parent commit's, ``git show
HEAD~1:<path> > build/parent.cu``; put such files under ``build/``, which git
ignores). The copies are made by editing the committed source's text:

- ``no staging``: the slice of the row's features is not copied to shared
  memory; each entry reads its 16 bytes per lane from device memory (L2),
  as the sorted kernel does, with the same segments and combine (no entry
  reads pixel 0 with weight 0 instead of a row of zeros);
- ``no combine``: a cut cell is stored with its owner's part only: the later
  warps' parts are dropped, so this copy disagrees by design;
- ``64-byte slices``: at most 4 lanes (64 bytes of a pixel) per slice:
  twice the blocks;
- ``no one-wave rule``: the slice stays as wide as the channels allow where
  narrower slices would still fit in one wave of blocks (few rows);
- ``16 warps``: 16 segments per block instead of 32.

Each version is built into ``build/b2_ablation/`` (one nvcc each, in
parallel, with ``--resource-usage``) and run on plans of the 6-camera ring
calibration (``chip_smoke.ring_camera_cells``, 40 depth bins, 28x50 pixels,
50x50 cells), seeded random features (C = 256) and softmax depth weights, at
48 rows (the geometric eval batch of 8) and 6 rows, in bf16 and f32. Each is
compared with the plain version (1e-5 of the terms' magnitudes, as phase 6)
and with the committed kernel's output bit for bit; the committed kernel
also with a second launch of itself. Then each is timed twice in turns
(forward order, then reverse, after an untimed warm-up pass over all): the
device time alone, by CUDA-graph replay.
Prints one line per run and, last, a JSON object of the medians.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import bev_pool as bp

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "b2_ablation"
ABLATIONS = {  # name: [(text of the committed source, its replacement)]
    "no staging": [
        ("    cp_async16(fs + i,", "    if (false) cp_async16(fs + i,"),
        ("unsigned src = zero_row;", "unsigned src = 0;"),
        ("entry_features<T>(fs, L, q,",
         "entry_features<T>(reinterpret_cast<const uint4*>(f_row), units, active ? unit : 0,"),
    ],
    "no combine": [("for (int v = 0; v < V; ++v) sum[v] += partial[(w * L + q) * 8 + v];", ";")],
    "64-byte slices": [("constexpr int kMaxLanes = 8;", "constexpr int kMaxLanes = 4;")],
    "no one-wave rule": [("while (lanes > 1 && blocks(lanes / 2) <= sms) lanes /= 2;", "")],
    "16 warps": [("constexpr int kSliceWarps = 32;", "constexpr int kSliceWarps = 16;")],
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


def _declare(lib: ctypes.CDLL) -> None:
    """Declares what every version has, and the config queries where they are."""
    try:
        bp._declare(lib)
    except AttributeError:  # an earlier version, whose launches take no scratch
        lib.bev_pool_sorted_config = lambda *args: 0  # 0 scratch bytes


def build_versions(sources: dict, out: Path) -> dict:
    """Builds each version (name: source text) into `out`, one nvcc each in
    parallel, prints each kernel's registers and spills, and loads them."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, lib = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "--resource-usage", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        usage = [line.strip() for line in log.splitlines()
                 if any(k in line for k in ("registers", "spill", "Function properties"))]
        print(f"built {name}:\n  " + "\n  ".join(usage), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        _declare(libs[name])
    return libs


def _inputs(cs, rows: int, dtype, g: torch.Generator) -> tuple:
    """Ring-calibration plans for `rows` camera rows (the 6 cameras tiled),
    features (rows, 1400, 256) and softmax weights over 40 depth bins."""
    pc_range = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    cells = np.tile(cs.ring_camera_cells((448, 800), (50, 50), 40, 1.0, 60.0, pc_range), (rows // 6, 1, 1, 1))
    plan = cs.device_plan(cells, 2500)
    logits = torch.randn(rows, 40, 1400, device="cuda", generator=g)
    weights = torch.softmax(logits, dim=1).reshape(rows, -1)
    feats = torch.randn(rows, 1400, 256, device="cuda", generator=g).to(dtype)
    return feats, weights, plan


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("others", nargs="*", help="other versions of csrc/bev_pool.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("b2_ablation: no CUDA device", file=sys.stderr)
        return 1
    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)

    libs = build_versions(_sources(args.others), OUT)
    current = ["committed"]
    _build.load = lambda name, declare: libs[current[0]]  # the wrapper launches `current`
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(11)
    order = list(libs) + list(libs)[::-1]
    results, configs = {}, {}
    for rows in (48, 6):
        for dtype in (torch.bfloat16, torch.float32):
            shape = f"{rows}x1400x256 {str(dtype)[6:]}"
            feats, weights, plan = _inputs(cs, rows, dtype, g)
            pool = lambda: bp.bev_pool_weighted_rows(feats, weights, *plan, 2500, 2560)
            want = bp.bev_pool_weighted_reference(feats, weights, *plan, 2500, 2560)
            scale = bp.bev_pool_weighted_reference(feats.abs(), weights, *plan, 2500, 2560)
            current[0] = "committed"
            configs[shape] = bp.weighted_config(feats, plan[0].shape[1])
            committed = pool()
            again = pool()
            print(f"{shape} committed: {configs[shape]}, two launches bit-identical: "
                  f"{torch.equal(committed, again)}", flush=True)
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
    summary = {shape: {name: float(np.median(runs)) for name, runs in per.items()}
               for shape, per in results.items()}
    print(json.dumps({"device_ms": summary, "committed_config": configs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
