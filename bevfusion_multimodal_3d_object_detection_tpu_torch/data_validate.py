"""Converted-data validator CLI of the port: the surface of the root
``data_validate.py`` (ref: data_validate.py:300-349):

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.data_validate
      [--config configs/base.yaml] [--split train|val|test]

Exits 1 when the config is missing or the validation fails
(ref: data_validate.py:340). `main(argv)` runs the same from Python.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Validate converted NuScenes data using config.yaml")
    parser.add_argument("--config", type=str, default="configs/base.yaml", help="Path to configuration file")
    parser.add_argument("--split", type=str, default=None, choices=["train", "val", "test"],
                        help="Validate specific split only (default: all)")
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
    if not validator.report() or not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
