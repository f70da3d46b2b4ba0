"""Kernel B1 (fused PointNet) on one card: the committed kernel beside
copies of it with one part taken out, and beside other versions of its
source, in turns within one process.

    python3 -m bevfusion_multimodal_3d_object_detection_tpu_torch.tools.b1_ablation [--f32] [other.cu ...]

from the repository root, on a machine with one CUDA card and `nvcc`. Each
`other.cu` is another version of ``csrc/pointnet_fused.cu`` with the same C
interface or an earlier one whose tile function takes only the working type
(for example the parent commit's, ``git show HEAD~1:<path> >
build/parent.cu``; put such files under ``build/``, which git ignores). The
ablated copies are made by editing the committed source's text. bf16 (the
default):

- ``no weight loads``: the cp.async copies of the weight slabs are skipped
  (the MMAs read whatever the ring holds);
- ``no MMAs``: the tensor-core instructions are dropped, every load, barrier
  and epilogue stays;
- ``ring depth 2``: one slab in flight instead of two;
- ``16-row slabs x 6``: half the rows per slab, twice the barriers, the same
  shared memory.

``--f32`` (the register-blocked exact-f32 layers):

- ``no weight loads``: the cp.async copies of the f32 weight slabs are
  skipped;
- ``no FMAs``: each k's 8 x CT FMAs of a thread become 8 + CT adds that keep
  every shared-memory load live (loads, barriers and epilogues stay);
- ``8 KB slabs x 3``: a three-deep ring of half-size slabs, twice the
  barriers, less shared memory.

``--f32`` also times the committed kernel at 1x35000 cut to the tiles that
fill whole waves of one tile per SM, to show what the last wave costs.

``--sweep N`` times nothing: it holds the committed bf16 kernel on phase 2's
dense 40x100 LiDAR case (one tight cluster per sample, every row a real
point) over N seeded weight and point sets (seed 0 .. N-1: the LiDAR chain
4->64->128->256->512->1024 with LeCun-normal weights, BatchNorm calibrated
on the seed's points, as phase 2 calibrates it), and holds both the kernel
and the plain bf16 version against a float64 version of the same chain
(the same bf16 inputs and weights, no rounding between layers), in units of
phase 2's bf16 limit. Prints one line per seed and, last, a JSON object of
the largest errors and the seeds where the kernel's error exceeds the plain
version's.

Every version is built into ``build/b1_ablation/`` (one nvcc each, in
parallel) and run on phase 2's calibrated seeded weights
(``chip_smoke.b1_encoders``): in bf16 at the serving shapes (LiDAR
8x35000x4 -> ...1024, radar 40x125x7 -> ...256), in f32 (TF32 off) at
LiDAR 1x35000x4 and 4x35000x4 (the engine's and an eval batch's). Each is
compared with the plain version (the ablated copies disagree by design)
and, in f32, checked for bit-identity with the committed kernel's output;
then timed twice in turns (forward order, then reverse): the device time
alone, by CUDA-graph replay, and the time through the wrapper. Prints one
line per run and, last, a JSON object of the medians.
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
from ..ops import pointnet_fused as pf

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "b1_ablation"
MMA = "mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);"
F32_FMA = "acc[i][c] = fmaf(av[i], wv[c], acc[i][c]);"
F32_ABLATIONS = {  # the same, for the f32 path
    "no weight loads": [("if (r.q[i] < quads)", "if (false)")],
    "no FMAs": [(F32_FMA, "{ if (c == 0) acc[i][0] += av[i]; if (i == 0) acc[0][c] += wv[c]; }")],
    "8 KB slabs x 3": [("constexpr int kF32Stages = 2;", "constexpr int kF32Stages = 3;"),
                       ("constexpr int kF32SlabElems = 4096;", "constexpr int kF32SlabElems = 2048;")],
}
ABLATIONS = {  # name: [(text of the committed source, its replacement)]
    "no weight loads": [("if (row < rows && c < chunks)", "if (false)")],
    "no MMAs": [(MMA, ";")],
    "ring depth 2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "16-row slabs x 6": [("constexpr int kStages = 3;", "constexpr int kStages = 6;"),
                         ("constexpr int kSlabK = 32;", "constexpr int kSlabK = 16;")],
}


def _sources(others, ablations) -> dict:
    src = (_build.CSRC / _build.SOURCES["pointnet_fused"]).read_text()
    out = {"committed": src}
    for name, edits in ablations.items():
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32", action="store_true", help="ablate and time the f32 path")
    parser.add_argument("--sweep", type=int, metavar="N",
                        help="hold bf16 B1 on the dense 40x100 LiDAR case over N seeds against float64")
    parser.add_argument("others", nargs="*", help="other versions of csrc/pointnet_fused.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    from ..config import DetectorSpec, load_config
    from ..models.detector import MultiModal3DDetector

    if args.sweep:
        return _sweep(cs, args.sweep)

    libs = _build_all(_sources(args.others, F32_ABLATIONS if args.f32 else ABLATIONS))
    current = ["committed"]
    _build.load = lambda name, declare: libs[current[0]]  # the wrapper launches `current`

    spec = DetectorSpec.from_config(load_config(str(ROOT / "configs" / "base.yaml")))
    g = torch.Generator().manual_seed(0)
    full = MultiModal3DDetector(spec).init_weights(g).eval()
    encoders, rng = cs.b1_encoders(full, g)
    if args.f32:
        dtype = torch.float32
        shapes = {f"lidar {b}x35000": (encoders["lidar"], cs.lidar_points(rng, b + 1, 35000)[:b])
                  for b in (1, 4)}
    else:
        dtype = torch.bfloat16
        shapes = {
            "lidar 8x35000": (encoders["lidar"], cs.lidar_points(rng, 8, spec.lidar.max_points)),
            "radar 40x125": (encoders["radar"], cs.radar_points(
                rng, 8 * spec.radar.num_radars, spec.radar.max_points_per_sensor)),
        }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = list(libs) + list(libs)[::-1]
    results = {}
    for shape, (enc, pts) in shapes.items():
        x, w, b = cs.chain_args(enc, pts, dtype, "cuda")
        want = pf.pointnet_fused_reference(x, w, b)
        current[0] = "committed"
        committed = pf.pointnet_fused(x, w, b)
        for name in order:
            current[0] = name
            got = pf.pointnet_fused(x, w, b)
            agrees = cs.compare(got, want, dtype)["worst"] <= 1.0
            same = f", bit-identical to the committed kernel: {torch.equal(got, committed)}" if args.f32 else ""
            dev = cs.graph_ms(lambda: pf.pointnet_fused(x, w, b))
            eager = cs.time_ms(lambda: pf.pointnet_fused(x, w, b))
            results.setdefault(shape, {}).setdefault(name, []).append((dev, eager))
            print(f"{shape} {str(dtype)[6:]} {name}: device {dev:.4f} ms, through the wrapper {eager:.4f} ms, "
                  f"agrees with the plain version: {agrees}{same}", flush=True)
    summary = {shape: {name: {"device_ms": float(np.median([d for d, _ in runs])),
                              "wrapper_ms": float(np.median([e for _, e in runs]))}
                       for name, runs in per.items()}
               for shape, per in results.items()}
    if args.f32:
        summary["wave tail"] = _wave_tail(cs, *shapes["lidar 1x35000"], current)
    print(json.dumps(summary))
    return 0


def _float64_chain(x, weights, biases) -> torch.Tensor:
    """The chain of the plain version in float64 with no rounding between
    layers, on the same (bf16) inputs and weights; max over every point."""
    h = x.double()
    for w, b in zip(weights, biases):
        h = torch.relu(h @ w.double() + b.double())
    return h.amax(dim=1)


def _sweep(cs, n: int) -> int:
    from ..config import LidarEncoderSpec
    from ..models.encoders import PointNetLiDAREncoder

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dtype, rows = torch.bfloat16, {}
    for seed in range(n):
        g, rng = torch.Generator().manual_seed(seed), np.random.RandomState(seed)
        enc = PointNetLiDAREncoder(LidarEncoderSpec()).eval()
        with torch.no_grad():
            for m in enc.modules():
                if isinstance(m, torch.nn.Linear):
                    m.weight.normal_(0.0, m.in_features ** -0.5, generator=g)
        cs.calibrate_point_mlp(enc.point_mlp, cs.lidar_points(rng, 2, 4096), g)
        x, w, b = cs.chain_args(enc, cs.dense_points(rng, 40, 100, 4, 40.0), dtype, "cuda")
        got, plain = pf.pointnet_fused(x, w, b), pf.pointnet_fused_reference(x, w, b)
        exact = _float64_chain(x, w, b).float()
        row = {"kernel_vs_plain": cs.compare(got, plain, dtype)["worst"],
               "kernel_vs_f64": cs.compare(got, exact, dtype)["worst"],
               "plain_vs_f64": cs.compare(plain, exact, dtype)["worst"]}
        rows[seed] = row
        print(f"seed {seed}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()) + " of the limit", flush=True)
    worse = [s for s, r in rows.items() if r["kernel_vs_f64"] > r["plain_vs_f64"]]
    print(json.dumps({
        "seeds": n, "case": "dense lidar 40x100x4 bf16, mask off",
        "max": {k: max(r[k] for r in rows.values()) for k in ("kernel_vs_plain", "kernel_vs_f64", "plain_vs_f64")},
        "seeds_over_limit": [s for s, r in rows.items() if r["kernel_vs_plain"] > 1.0],
        "seeds_kernel_worse_than_plain_vs_f64": worse,
    }))
    return 0


def _wave_tail(cs, enc, pts, current) -> dict:
    """The committed kernel at 1x35000 against the same sample cut to the
    tiles that fill whole waves of one tile per SM: what the last, partial
    wave costs."""
    current[0] = "committed"
    x, w, b = cs.chain_args(enc, pts, torch.float32, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = pf.kernel_tile_points(torch.float32, [x.shape[2]] + [v.shape[1] for v in w])
    tiles = -(-x.shape[1] // tile)
    cut = x[:, : tiles // sms * sms * tile].contiguous()
    out = {"tiles": tiles, "sms": sms, "waves": tiles / sms, "points_full_waves": cut.shape[1],
           "full_waves_ms": cs.graph_ms(lambda: pf.pointnet_fused(cut, w, b)),
           "all_ms": cs.graph_ms(lambda: pf.pointnet_fused(x, w, b))}
    print(f"wave tail: {tiles} tiles of {tile} points on {sms} SMs ({tiles / sms:.2f} waves); "
          f"{tiles // sms} full waves {out['full_waves_ms']:.4f} ms, all {out['all_ms']:.4f} ms", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
