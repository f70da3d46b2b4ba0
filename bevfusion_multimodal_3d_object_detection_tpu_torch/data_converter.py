"""nuScenes -> info pickles CLI of the port: the surface of the root
``data_converter.py`` (ref: data_converter.py:454-517):

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.data_converter
      [--config configs/base.yaml] [--split train|val|test] [--show-config]

`data.converter.ConfigDrivenNuScenesConverter` on every split, or the one
given. Exits 1 when the config is missing; without the nuScenes devkit,
``--show-config`` still works and a conversion stops with the converter's
ImportError. `main(argv)` runs the same from Python.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Convert NuScenes to info pickles using config.yaml")
    parser.add_argument("--config", type=str, default="configs/base.yaml", help="Path to configuration file")
    parser.add_argument("--split", type=str, default=None, choices=["train", "val", "test"],
                        help="Convert specific split only (default: all)")
    parser.add_argument("--show-config", action="store_true", help="Show configuration summary and exit")
    args = parser.parse_args(argv)

    from .data.converter import ConfigDrivenNuScenesConverter

    try:
        converter = ConfigDrivenNuScenesConverter(config_path=args.config)
    except FileNotFoundError:
        print(f"Error: Configuration file '{args.config}' not found!")
        sys.exit(1)
    except ImportError as e:
        print(f"Error: {e}")
        sys.exit(1)

    if args.show_config:
        converter.show_config()
        return

    for split in [args.split] if args.split else ["train", "val", "test"]:
        infos = converter.convert_split(split)
        converter.save_infos(infos, split)


if __name__ == "__main__":
    main()
