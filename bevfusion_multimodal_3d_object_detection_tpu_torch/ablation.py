"""Ablation runner of the port: the surface of the root ``ablation.py``
(``:21-121``), on one GPU unless ``--device cpu``:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.ablation
      [--config configs/base.yaml] [--out ablation_results.txt] [--device cuda|cpu] [--eval]

For every modality set in ``ablation.modality_ablation.configs`` and every
fusion type in ``ablation.fusion_ablation.fusion_types`` it builds the
detector (``mask_padding = not compat.unmasked_point_padding``; the head
follows the fusion as the factory forces it), seeds it, runs one eval-mode
forward at batch 1 on zero inputs of the config's shapes, and reports PASS
or FAIL, the parameter count and the output signature, in the JAX runner's
format. ``--eval`` is accepted and does nothing, as in the JAX runner,
which parses it and never reads it. `main(argv)` runs the same from Python
and returns the rows (modality, fusion, status, parameters, signature,
seconds).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Tuple

Row = Tuple[str, str, str, int, str, float]


def main(argv: Optional[List[str]] = None) -> List[Row]:
    parser = argparse.ArgumentParser(description="Ablation study runner")
    parser.add_argument("--config", type=str, default="configs/base.yaml")
    parser.add_argument("--eval", action="store_true",
                        help="accepted for the JAX runner's surface; it evaluates nothing there either")
    parser.add_argument("--out", type=str, default="ablation_results.txt")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="Execution device")
    args = parser.parse_args(argv)

    import torch

    from .config import CompatFlags, DetectorSpec, load_config
    from .models.detector import MultiModal3DDetector
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    ab = config.get("ablation", {}) or {}
    modality_configs = ((ab.get("modality_ablation", {}) or {}).get("configs")
                        or ["camera_only", "lidar_only", "camera+lidar", "camera+lidar+radar"])
    fusion_types = ((ab.get("fusion_ablation", {}) or {}).get("fusion_types")
                    or ["bev", "attention", "late"])
    compat = CompatFlags.from_config(config)

    rows: List[Row] = []
    for modality in modality_configs:
        for fusion in fusion_types:
            spec = DetectorSpec.from_config(config, modality_config=modality, fusion_type=fusion)
            h, w = spec.camera.image_size
            zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
            cams = zeros(1, 6, h, w, 3) if spec.use_camera else None
            lidar = zeros(1, spec.lidar.max_points, 4) if spec.use_lidar else None
            radars = (zeros(1, spec.radar.num_radars, spec.radar.max_points_per_sensor, 7)
                      if spec.use_radar else None)
            t0 = time.time()
            try:
                with torch.device(device):  # parameters made on the device
                    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding)
                model.init_weights(torch.Generator(device=device).manual_seed(0)).eval()
                with torch.inference_mode():
                    out = model(cams, lidar, radars)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                n_params = sum(p.numel() for p in model.parameters())
                sig = ", ".join(f"{k}{tuple(v.shape)}" for k, v in sorted(out.items()))
                rows.append((modality, fusion, "PASS", n_params, sig, time.time() - t0))
                print(f"{modality:22s} {fusion:10s} PASS {n_params:>12,} params ({time.time() - t0:.1f}s)")
                del model, out
            except Exception as e:
                rows.append((modality, fusion, f"FAIL: {e}", 0, "", 0.0))
                print(f"{modality:22s} {fusion:10s} FAIL: {e}")

    lines = [
        "===== Ablation Study =====",
        f"{'modality':22s} {'fusion':10s} {'status':6s} {'params':>14s}  outputs",
    ]
    for modality, fusion, status, n, sig, _ in rows:
        lines.append(f"{modality:22s} {fusion:10s} {status.split(':')[0]:6s} {n:>14,}  {sig}")
    Path(args.out).write_text("\n".join(lines) + "\n")
    print(f"\nResults saved to {args.out}")
    return rows


if __name__ == "__main__":
    main()
