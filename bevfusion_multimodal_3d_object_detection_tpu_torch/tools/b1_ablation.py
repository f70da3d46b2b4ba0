"""Kernel B1 (fused PointNet) on one card: the committed kernel beside
copies of it with one part taken out, and beside other versions of its
source, in turns within one process.

    python3 -m bevfusion_multimodal_3d_object_detection_tpu_torch.tools.b1_ablation [other.cu ...]

from the repository root, on a machine with one CUDA card and `nvcc`. Each
`other.cu` is another version of ``csrc/pointnet_fused.cu`` with the same C
interface (for example a parent commit's, from ``git show``). The ablated
copies are made by editing the committed source's text:

- ``no weight loads``: the cp.async copies of the weight slabs are skipped
  (the MMAs read whatever the ring holds);
- ``no MMAs``: the tensor-core instructions are dropped, every load, barrier
  and epilogue stays;
- ``ring depth 2``: one slab in flight instead of two;
- ``16-row slabs x 6``: half the rows per slab, twice the barriers, the same
  shared memory.

Every version is built into ``build/b1_ablation/`` (one nvcc each, in
parallel), run at the serving shapes in bf16 (LiDAR 8x35000x4 -> ...1024,
radar 40x125x7 -> ...256) on chip_smoke.py's calibrated seeded weights,
compared with the plain version (the ablated copies disagree by design), and
timed twice in turns (forward order, then reverse): the device time alone,
by CUDA-graph replay, and the time through the wrapper. Prints one line per
run and, last, a JSON object of the medians.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import pointnet_fused as pf

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "b1_ablation"
MMA = "mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);"
ABLATIONS = {  # name: [(text of the committed source, its replacement)]
    "no weight loads": [("if (row < rows && c < chunks)", "if (false)")],
    "no MMAs": [(MMA, ";")],
    "ring depth 2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "16-row slabs x 6": [("constexpr int kStages = 3;", "constexpr int kStages = 6;"),
                         ("constexpr int kSlabK = 32;", "constexpr int kSlabK = 16;")],
}


def _sources(others) -> dict:
    src = (_build.CSRC / _build.SOURCES["pointnet_fused"]).read_text()
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


def _build_all(sources: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, lib = OUT / f"v{i}.cu", OUT / f"libv{i}.so"
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
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        print(f"built {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        pf._declare(libs[name])
    return libs


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("b1_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    from ..config import DetectorSpec, load_config
    from ..models.detector import MultiModal3DDetector

    libs = _build_all(_sources(sys.argv[1:] if argv is None else argv))
    current = ["committed"]
    _build.load = lambda name, declare: libs[current[0]]  # the wrapper launches `current`

    spec = DetectorSpec.from_config(load_config(str(ROOT / "configs" / "base.yaml")))
    g = torch.Generator().manual_seed(0)
    full = MultiModal3DDetector(spec).init_weights(g).eval()
    rng = np.random.RandomState(0)
    cs.calibrate_point_mlp(full.lidar_encoder.point_mlp, cs.lidar_points(rng, 2, 4096), g)
    cs.calibrate_point_mlp(full.radar_encoder.shared_radar.point_mlp, cs.radar_points(rng, 8, 125), g)
    shapes = {
        "lidar 8x35000": (full.lidar_encoder, cs.lidar_points(rng, 8, spec.lidar.max_points)),
        "radar 40x125": (full.radar_encoder.shared_radar, cs.radar_points(
            rng, 8 * spec.radar.num_radars, spec.radar.max_points_per_sensor)),
    }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = list(libs) + list(libs)[::-1]
    results = {}
    for shape, (enc, pts) in shapes.items():
        x, w, b = cs.chain_args(enc, pts, torch.bfloat16, "cuda")
        want = pf.pointnet_fused_reference(x, w, b)
        for name in order:
            current[0] = name
            agrees = cs.compare(pf.pointnet_fused(x, w, b), want, torch.bfloat16)["worst"] <= 1.0
            dev = cs.graph_ms(lambda: pf.pointnet_fused(x, w, b))
            eager = cs.time_ms(lambda: pf.pointnet_fused(x, w, b))
            results.setdefault(shape, {}).setdefault(name, []).append((dev, eager))
            print(f"{shape} bf16 {name}: device {dev:.4f} ms, through the wrapper {eager:.4f} ms, "
                  f"agrees with the plain version: {agrees}", flush=True)
    print(json.dumps({shape: {name: {"device_ms": float(np.median([d for d, _ in runs])),
                                     "wrapper_ms": float(np.median([e for _, e in runs]))}
                              for name, runs in per.items()}
                      for shape, per in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
