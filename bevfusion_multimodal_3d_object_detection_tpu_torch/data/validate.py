"""Converted-data validator: the port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/data/validate.py:20-163``
(ref: data_validate.py:14-346 and validate_data_with_samples.py:14-461).

Checks the pickle structure, the metadata against the config, each sample's
schema ((N, 7) boxes, NaNs, camera and radar completeness, known classes),
prints statistics and, on request, the GT boxes of the first samples.
`report` returns whether there was no error; the CLIs exit 1 on failure, as
the reference does (data_validate.py:340)."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import load_config


class ConfigDrivenDataValidator:
    def __init__(self, config_path: str = "configs/base.yaml"):
        self.config = load_config(config_path)
        d = self.config.get("dataset")
        if not isinstance(d, dict):
            raise ValueError(
                f"{config_path}: config has no 'dataset' section to "
                f"validate against"
            )
        self.data_root = Path(d.get("data_root", "data/nuscenes"))
        self.classes = list(d.get("classes", []))
        self.camera_types = list((d.get("cameras", {}) or {}).get("names", []))
        self.radar_types = list((d.get("radars", {}) or {}).get("names", []))
        self.errors: List[str] = []
        self.warnings: List[str] = []

    # -- loading ----------------------------------------------------------------
    def load_split(self, split: str) -> Optional[Dict]:
        pkl = self.data_root / f"nuscenes_infos_{split}.pkl"
        if not pkl.exists():
            self.errors.append(f"missing pickle: {pkl}")
            return None
        with open(pkl, "rb") as f:
            return pickle.load(f)

    # -- checks -------------------------------------------------------------------
    def validate_structure(self, data: Dict) -> bool:
        ok = True
        for key in ("infos", "metadata"):
            if key not in data:
                self.errors.append(f"top-level key missing: {key}")
                ok = False
        return ok

    def validate_metadata(self, data: Dict) -> bool:
        ok = True
        meta = data.get("metadata", {})
        for key in ("version", "classes", "num_classes"):
            if key not in meta:
                self.errors.append(f"metadata key missing: {key}")
                ok = False
        if self.classes and list(meta.get("classes", [])) != self.classes:
            self.errors.append(
                "metadata classes differ from config classes"
            )
            ok = False
        return ok

    def validate_sample(self, info: Dict, idx: int) -> bool:
        ok = True
        for key in ("token", "lidar_path", "cams", "radars",
                    "gt_boxes", "gt_names", "gt_velocity"):
            if key not in info:
                self.errors.append(f"sample {idx}: key missing: {key}")
                ok = False
        if not ok:
            return False

        boxes = np.asarray(info["gt_boxes"])
        if boxes.size and (boxes.ndim != 2 or boxes.shape[1] != 7):
            self.errors.append(
                f"sample {idx}: gt_boxes shape {boxes.shape} != (N, 7)"
            )
            ok = False
        if boxes.size and np.isnan(boxes).any():
            self.errors.append(f"sample {idx}: NaN in gt_boxes")
            ok = False
        if len(info["gt_names"]) != len(boxes):
            self.errors.append(f"sample {idx}: gt_names/gt_boxes mismatch")
            ok = False
        for cam in self.camera_types:
            if cam not in info["cams"]:
                self.warnings.append(f"sample {idx}: missing camera {cam}")
        for radar in self.radar_types:
            if radar not in info["radars"]:
                self.warnings.append(f"sample {idx}: missing radar {radar}")
        if self.classes:  # same guard as the metadata check: an empty
            # config class list means "nothing to compare against", not
            # "every class is unknown"
            unknown = set(map(str, info["gt_names"])) - set(self.classes)
            if unknown:
                self.errors.append(
                    f"sample {idx}: unknown classes {unknown}"
                )
                ok = False
        return ok

    # -- per split ----------------------------------------------------------------
    def validate_split(self, split: str, max_samples: Optional[int] = None) -> bool:
        data = self.load_split(split)
        if data is None:
            return False
        ok = self.validate_structure(data) and self.validate_metadata(data)
        infos = data.get("infos", [])
        n = len(infos) if max_samples is None else min(len(infos), max_samples)
        for i in range(n):
            ok = self.validate_sample(infos[i], i) and ok
        self.print_statistics(split, data)
        return ok

    def print_statistics(self, split: str, data: Dict) -> None:
        infos = data.get("infos", [])
        n_boxes = [len(np.asarray(i.get("gt_boxes", []))) for i in infos]
        print(f"\n=== {split} split statistics ===")
        print(f"samples: {len(infos)}")
        if n_boxes:
            print(
                f"gt boxes/sample: min={min(n_boxes)} max={max(n_boxes)} "
                f"mean={np.mean(n_boxes):.1f}"
            )
        counts: Dict[str, int] = {}
        for info in infos:
            for name in map(str, info.get("gt_names", [])):
                counts[name] = counts.get(name, 0) + 1
        for name in sorted(counts):
            print(f"  {name:22s}: {counts[name]}")

    def print_sample_boxes(self, split: str, num_samples: int = 3) -> None:
        """Formatted per-sample GT dump
        (ref: validate_data_with_samples.py:219-302)."""
        data = self.load_split(split)
        if data is None:
            return
        for i, info in enumerate(data["infos"][:num_samples]):
            print(f"\n--- sample {i}: token={info['token']} ---")
            boxes = np.asarray(info["gt_boxes"]).reshape(-1, 7)
            names = list(map(str, info["gt_names"]))
            for j, (b, name) in enumerate(zip(boxes, names)):
                print(
                    f"  [{j:2d}] {name:22s} "
                    f"xyz=({b[0]:7.2f},{b[1]:7.2f},{b[2]:6.2f}) "
                    f"wlh=({b[3]:5.2f},{b[4]:5.2f},{b[5]:5.2f}) "
                    f"yaw={b[6]:6.2f}"
                )

    def report(self) -> bool:
        print(f"\nerrors: {len(self.errors)}, warnings: {len(self.warnings)}")
        for e in self.errors[:50]:
            print(f"  ERROR: {e}")
        for w in self.warnings[:20]:
            print(f"  WARN:  {w}")
        if not self.errors:
            print("VALIDATION PASSED")
        return not self.errors
