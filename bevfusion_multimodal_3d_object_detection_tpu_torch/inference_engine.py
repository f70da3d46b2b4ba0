"""Single-sample inference engine with P/R/F1 and a 6-panel figure.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/inference_engine.py``
on one GPU (the CPU with ``device="cpu"``):

- the eval-mode forward in f32, with both point encoders on the fused
  PointNet kernel (B1; its plain version on the CPU), then the eval-path
  CenterNet decode (voxel 0.512, quirk Q3) above ``score_threshold`` 0.3,
  or the resurrected ``inference.post_processing`` (threshold, BEV NMS,
  cap) when ``compat.ignore_post_processing_config`` is off. The MLP head
  (attention and late fusion) gives one detection: its box, the softmax
  probability of its most probable class, zero velocities;
- per-sample P/R/F1 with the axis-aligned BEV IoU at 0.5 (yaw ignored, as
  the reference does) against the labelled GT boxes only;
- `batch_inference`: micro-averaged P/R/F1 over N samples;
- ``inference.save_predictions`` (a JSON per sample) and
  ``inference.fold_bn`` (camera BatchNorms folded into the convs after the
  restore into the unfolded tree);
- `visualize`: BEV boxes with heading arrows, the LiDAR scatter, the front
  camera with projected 3D boxes, the predicted heatmap, score bars and a
  class histogram, drawn with matplotlib's Agg backend.

Weights come from a msgpack checkpoint of either package or a reference
``.pth`` (`load_model`, through `utils.restore.load_serving_variables`), or
from the seeded init (`init_random`). ``camera_to_bev: geometric`` raises:
the engine has no frustum cells to give it (ROADMAP C).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .config import DEFAULT_CLASSES, CompatFlags, DetectorSpec, PostProcessSpec, load_config
from .models.detector import MultiModal3DDetector
from .ops.decode import decode_centernet_predictions, decode_to_host
from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from .train.loop import _model_inputs, mlp_detections
from .utils.convert import load_jax_variables
from .utils.device import resolve_device
from .utils.restore import load_serving_variables


def bev_iou_axis_aligned(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Axis-aligned BEV IoU, yaw ignored."""
    ax0, ay0 = box_a[0] - box_a[3] / 2, box_a[1] - box_a[4] / 2
    ax1, ay1 = box_a[0] + box_a[3] / 2, box_a[1] + box_a[4] / 2
    bx0, by0 = box_b[0] - box_b[3] / 2, box_b[1] - box_b[4] / 2
    bx1, by1 = box_b[0] + box_b[3] / 2, box_b[1] + box_b[4] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0


def precision_recall_f1(pred_boxes: np.ndarray, gt_boxes: np.ndarray, iou_thresh: float = 0.5):
    """Greedy IoU matching in prediction order -> (precision, recall, f1,
    tp, fp, fn)."""
    n_pred, n_gt = len(pred_boxes), len(gt_boxes)
    if n_pred == 0 and n_gt == 0:
        return 1.0, 1.0, 1.0, 0, 0, 0
    matched_gt = set()
    tp = 0
    for pb in pred_boxes:
        best_iou, best_gi = 0.0, -1
        for gi, gb in enumerate(gt_boxes):
            if gi in matched_gt:
                continue
            iou = bev_iou_axis_aligned(pb, gb)
            if iou > best_iou:
                best_iou, best_gi = iou, gi
        if best_iou >= iou_thresh and best_gi >= 0:
            matched_gt.add(best_gi)
            tp += 1
    fp = n_pred - tp
    fn = n_gt - tp
    precision = tp / n_pred if n_pred else 0.0
    recall = tp / n_gt if n_gt else 0.0
    f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
    return precision, recall, f1, tp, fp, fn


def _labelled_gt(sample: Dict) -> np.ndarray:
    """The sample's GT boxes with a label (unlabelled samples carry boxes
    without labels: all of them then)."""
    gt_boxes = np.asarray(sample.get("gt_boxes", np.zeros((0, 7))))
    gt_labels = np.asarray(sample.get("gt_labels", np.zeros(0, np.int64)))
    return gt_boxes[gt_labels >= 0] if gt_labels.size else gt_boxes


class InferenceEngine:
    def __init__(
        self,
        model_path: Optional[str] = None,
        config_path: str = "configs/base.yaml",
        score_threshold: float = 0.3,
        config: Optional[Dict] = None,
        fold_bn: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config if config is not None else load_config(config_path)
        self.compat = CompatFlags.from_config(self.config)
        self.spec = DetectorSpec.from_config(self.config)
        if self.spec.use_camera and self.spec.bev.camera_to_bev == "geometric":
            raise NotImplementedError(
                "camera_to_bev: geometric needs frustum cells, which the engine does not pass; "
                "the JAX engine then silently runs the pseudo camera-to-BEV instead "
                "(models/fusion.py:197-209), the port raises (ROADMAP C)"
            )
        self.classes = list((self.config.get("dataset", {}) or {}).get("classes", DEFAULT_CLASSES))
        self.score_threshold = score_threshold
        self.post_process = None
        if not self.compat.ignore_post_processing_config:
            self.post_process = PostProcessSpec.from_config(self.config, ("inference", "test"))
            self.score_threshold = self.post_process.score_threshold
        inference_cfg = self.config.get("inference", {}) or {}
        self.save_predictions = bool(inference_cfg.get("save_predictions", True))
        # checkpoints restore into the unfolded tree; the serving model then
        # runs with the camera BatchNorms folded into the convs
        self.fold_bn = bool(inference_cfg.get("fold_bn", False)) if fold_bn is None else fold_bn
        self.model = MultiModal3DDetector(
            self.spec, mask_padding=not self.compat.unmasked_point_padding, fold_bn=self.fold_bn,
        ).to(self.device).eval()
        self.variables = None
        if model_path is not None:
            self.load_model(model_path)
        if self.compat.eval_decode_voxel_0512:
            self.voxel_size = 0.512  # Q3
        else:
            x0, y0, _, x1, y1, _ = self.spec.bev.pc_range
            self.voxel_size = ((x1 - x0) / self.spec.bev.bev_w, (y1 - y0) / self.spec.bev.bev_h)

    # -- model ---------------------------------------------------------------
    def _set_variables(self, variables: Dict) -> None:
        """Load a JAX-layout tree (folded to match the model) into the model
        on its device."""
        load_jax_variables(self.model, variables)
        self.variables = variables

    def init_random(self, sample: Optional[Dict] = None) -> None:
        """The seeded weights (for runs without a checkpoint), with the
        pretrained camera trunk where ``camera_encoder.pretrained`` names a
        local file. `sample` is accepted for the JAX signature: the port's
        shapes do not depend on one."""
        self._set_variables(load_serving_variables(self.spec, None, fold_bn=self.fold_bn))

    def load_model(self, model_path: str, strict: bool = True) -> None:
        """Restore a msgpack checkpoint (either package's) or a reference
        ``.pth``. A failed restore raises; `strict=False` warns and takes
        the seeded weights instead, as the JAX engine does."""
        try:
            variables = load_serving_variables(self.spec, model_path, fold_bn=self.fold_bn)
        except Exception as e:
            if strict:
                raise RuntimeError(f"failed to restore checkpoint '{model_path}': {e}") from e
            print(f"Warning: failed to restore '{model_path}' ({e}); using random init")
            variables = load_serving_variables(self.spec, None, fold_bn=self.fold_bn)
        else:
            if str(model_path).endswith((".pth", ".pt")):
                print(f"Migrated reference torch checkpoint {model_path}")
        self._set_variables(variables)

    @torch.inference_mode()
    def _forward(self, sample: Dict):
        """One sample's predictions (NHWC maps, or the MLP head's {'cls',
        'box'}; batch 1) and the maps' fixed-size decode (None for the MLP
        head), on the device."""
        batch = {k: np.asarray(sample[k])[None] for k in ("camera_imgs", "lidar_points", "radar_points")
                 if k in sample}
        preds = self.model(*_model_inputs(self.spec, batch, self.device, torch.float32))
        if not self.spec.head_is_centernet:
            return preds, None
        decoded = decode_centernet_predictions(
            preds,
            max_detections=self.spec.centernet.max_detections,
            voxel_size=self.voxel_size,
            pc_range=self.spec.bev.pc_range,
            class_always_zero=self.compat.decode_class_always_zero,
        )
        return preds, decoded

    # -- inference -----------------------------------------------------------
    def run_inference(self, sample: Dict, visualize: bool = True, save_dir: Optional[str] = None) -> Dict:
        if self.variables is None:
            raise RuntimeError("load_model or init_random first")
        t0 = time.perf_counter()
        preds, decoded = self._forward(sample)
        # the host copy of the outputs waits for the device work
        if decoded is None:  # the MLP head (inference_engine.py:288-299 of the JAX package)
            dets = dict(mlp_detections(preds)[0], velocities=np.zeros((1, 2)))
        else:
            dets = decode_to_host(
                decoded,
                score_thresh=self.score_threshold,
                nms_thresh=self.post_process.nms_threshold if self.post_process else None,
                max_detections=self.post_process.max_detections if self.post_process else None,
            )[0]
        elapsed = time.perf_counter() - t0

        p, r, f1, tp, fp, fn = precision_recall_f1(dets["boxes"], _labelled_gt(sample))
        result = {
            "detections": dets, "precision": p, "recall": r, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn, "latency_s": elapsed,
        }
        self._print_detections(dets)
        if visualize:
            result["figure_path"] = self.visualize(sample, dets, preds, save_dir=save_dir)
        if save_dir is not None and self.save_predictions:
            result["predictions_path"] = self._save_predictions(sample, dets, save_dir)
        return result

    def _save_predictions(self, sample: Dict, dets: Dict, save_dir: str) -> str:
        """Write the detections as JSON (``inference.save_predictions``)."""
        out_dir = Path(save_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        token = sample.get("token", "sample")
        path = out_dir / f"predictions_{token}.json"
        payload = {
            "token": token,
            "detections": [
                {
                    "box": [float(v) for v in dets["boxes"][i]],
                    "score": float(dets["scores"][i]),
                    "label": int(dets["labels"][i]),
                    "class": self.classes[int(dets["labels"][i]) % len(self.classes)],
                    "velocity": [float(v) for v in dets["velocities"][i]],
                }
                for i in range(len(dets["scores"]))
            ],
        }
        path.write_text(json.dumps(payload, indent=1))
        return str(path)

    def batch_inference(self, dataset, num_samples: int = 10, save_dir: Optional[str] = None) -> Dict:
        """Micro-averaged P/R/F1 over the first `num_samples` samples."""
        total_tp = total_fp = total_fn = 0
        times = []
        n = min(num_samples, len(dataset))
        for i in range(n):
            res = self.run_inference(dataset[i], visualize=False, save_dir=save_dir)
            total_tp += res["tp"]
            total_fp += res["fp"]
            total_fn += res["fn"]
            times.append(res["latency_s"])
        precision = total_tp / max(total_tp + total_fp, 1)
        recall = total_tp / max(total_tp + total_fn, 1)
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
        summary = {
            "num_samples": n,
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "mean_latency_s": float(np.mean(times)) if times else 0.0,
            "samples_per_sec": n / float(np.sum(times)) if times else 0.0,
        }
        print(f"\nBatch inference over {n} samples: P={precision:.3f} R={recall:.3f} F1={f1:.3f} "
              f"({summary['samples_per_sec']:.2f} samples/s)")
        return summary

    # -- output --------------------------------------------------------------
    def _print_detections(self, dets: Dict, top: int = 10) -> None:
        print(f"\nDetections: {len(dets['scores'])}")
        for i in np.argsort(-dets["scores"])[:top]:
            b = dets["boxes"][i]
            cls = self.classes[int(dets["labels"][i]) % len(self.classes)]
            print(
                f"  {cls:20s} score={dets['scores'][i]:.3f} "
                f"xyz=({b[0]:6.1f},{b[1]:6.1f},{b[2]:5.1f}) "
                f"wlh=({b[3]:4.1f},{b[4]:4.1f},{b[5]:4.1f}) yaw={b[6]:5.2f}"
            )

    def visualize(self, sample: Dict, dets: Dict, preds: Optional[Dict] = None,
                  save_dir: Optional[str] = None) -> str:
        """The 6-panel figure as a PNG in `save_dir` (./inference_results by
        default); returns its path. Needs matplotlib."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        from .utils.box_geometry import BOX_EDGES, project_box_to_image

        fig, axes = plt.subplots(2, 3, figsize=(18, 10))
        gt_boxes = _labelled_gt(sample)

        # (0,0) BEV with heading arrows
        ax = axes[0, 0]
        for boxes, color, lw in ((gt_boxes, "green", 1.5), (dets["boxes"], "red", 1.0)):
            for b in boxes:
                ax.add_patch(Rectangle((b[0] - b[3] / 2, b[1] - b[4] / 2), b[3], b[4],
                                       fill=False, edgecolor=color, lw=lw))
                ax.arrow(b[0], b[1], 2 * np.cos(b[6]), 2 * np.sin(b[6]), color=color, head_width=0.8)
        ax.set_xlim(-55, 55)
        ax.set_ylim(-55, 55)
        ax.set_title("BEV (green=GT, red=pred)")
        ax.set_aspect("equal")

        # (0,1) LiDAR scatter
        ax = axes[0, 1]
        pts = np.asarray(sample.get("lidar_points", np.zeros((0, 4))))
        if len(pts):
            sub = pts[:: max(1, len(pts) // 10000)]
            ax.scatter(sub[:, 0], sub[:, 1], s=0.2, c=sub[:, 2], cmap="viridis")
        ax.set_title("LiDAR points (BEV)")
        ax.set_aspect("equal")

        # (0,2) front camera (denormalized) with the projected 3D boxes
        ax = axes[0, 2]
        cams = sample.get("camera_imgs")
        if cams is not None and len(cams):
            img = np.asarray(cams[0])
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            else:
                img = np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1)
            ax.imshow(img)
            proj = sample.get("cam_front_projection")
            if proj is not None:
                hw = img.shape[:2]
                for boxes, color in ((gt_boxes, "lime"), (dets["boxes"], "red")):
                    for b in boxes:
                        uv = project_box_to_image(b, proj["intrinsic"], proj["rot"], proj["trans"], hw)
                        if uv is None:
                            continue
                        for i, j in BOX_EDGES:
                            ax.plot([uv[i, 0], uv[j, 0]], [uv[i, 1], uv[j, 1]], color=color, lw=0.8)
                ax.set_xlim(0, hw[1])
                ax.set_ylim(hw[0], 0)
        ax.set_title("CAM_FRONT (projected boxes)")
        ax.axis("off")

        # (1,0) heatmap, max over classes
        ax = axes[1, 0]
        if preds is not None and "heatmap" in preds:
            hm = preds["heatmap"][0].float().amax(dim=-1).cpu().numpy()
            ax.imshow(hm, cmap="hot", origin="lower")
        ax.set_title("Predicted heatmap (max over classes)")

        # (1,1) score bars
        ax = axes[1, 1]
        order = np.argsort(-dets["scores"])[:20]
        ax.bar(range(len(order)), dets["scores"][order], color="steelblue")
        ax.set_title("Top detection scores")
        ax.set_ylim(0, 1)

        # (1,2) class histogram
        ax = axes[1, 2]
        if len(dets["labels"]):
            counts = np.bincount(dets["labels"].astype(int) % len(self.classes), minlength=len(self.classes))
            ax.bar(range(len(self.classes)), counts, color="darkorange")
            ax.set_xticks(range(len(self.classes)))
            ax.set_xticklabels(self.classes, rotation=60, fontsize=7)
        ax.set_title("Detections per class")

        out_dir = Path(save_dir or "./inference_results")
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path = out_dir / f"inference_{sample.get('token', 'sample')}.png"
        fig.tight_layout()
        fig.savefig(out_path, dpi=100)
        plt.close(fig)
        print(f"Saved visualization to {out_path}")
        return str(out_path)
