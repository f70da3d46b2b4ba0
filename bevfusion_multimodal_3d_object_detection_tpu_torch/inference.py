"""Inference CLI of the port: the surface of the root ``inference.py``
(``:14-73``), on one GPU unless ``--device cpu``:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.inference --model <ckpt>
      [--config configs/base.yaml] [--data-root ./data/nuscenes] [--sample-idx 0]
      [--split test] [--device cuda|cpu] [--no-show] [--save-dir ./inference_results]
      [--batch N]

One sample through `InferenceEngine.run_inference` (with the 6-panel
figure unless ``--no-show``; it needs matplotlib), or ``--batch N`` samples
through `batch_inference`. `main(argv)` runs the same from Python.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description="3D Detection Inference")
    parser.add_argument("--model", type=str, required=True, help="Path to model checkpoint")
    parser.add_argument("--config", type=str, default="configs/base.yaml", help="Path to config file")
    parser.add_argument("--data-root", type=str, default="./data/nuscenes", help="Data root directory")
    parser.add_argument("--sample-idx", type=int, default=0, help="Sample index")
    parser.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="Execution device")
    parser.add_argument("--no-show", action="store_true", help="Don't save visualizations")
    parser.add_argument("--save-dir", type=str, default="./inference_results", help="Save directory")
    parser.add_argument("--batch", type=int, default=None, help="Run batch inference on N samples")
    args = parser.parse_args(argv)

    from .data.dataset import NuScenesDataset
    from .inference_engine import InferenceEngine

    engine = InferenceEngine(model_path=args.model, config_path=args.config, device=args.device)
    dataset = NuScenesDataset(data_root=args.data_root, split=args.split, config=engine.config, seed=0)
    if args.batch is not None:
        return engine.batch_inference(dataset, num_samples=args.batch, save_dir=args.save_dir)
    return engine.run_inference(dataset[args.sample_idx], visualize=not args.no_show, save_dir=args.save_dir)


if __name__ == "__main__":
    main()
