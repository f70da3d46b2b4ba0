"""Validator and GT-sample printer CLI of the port: the surface of the root
``validate_data_with_samples.py`` (ref: validate_data_with_samples.py:409-461):

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.validate_data_with_samples
      [--config configs/base.yaml] [--split train|val|test] [--samples 5]

Exits 1 when the config is missing or the validation fails. `main(argv)`
runs the same from Python.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Validate converted NuScenes data and print GT samples")
    parser.add_argument("--config", type=str, default="configs/base.yaml", help="Path to configuration file")
    parser.add_argument("--split", type=str, default=None, choices=["train", "val", "test"],
                        help="Validate specific split only (default: all)")
    parser.add_argument("--samples", type=int, default=5, help="Number of GT samples to print")
    args = parser.parse_args(argv)

    from .data.validate import ConfigDrivenDataValidator

    try:
        validator = ConfigDrivenDataValidator(config_path=args.config)
    except FileNotFoundError:
        print(f"Error: Configuration file '{args.config}' not found!")
        sys.exit(1)

    ok = True
    for split in [args.split] if args.split else ["train", "val", "test"]:
        ok = validator.validate_split(split) and ok
        validator.print_sample_boxes(split, num_samples=args.samples)
    if not validator.report() or not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
