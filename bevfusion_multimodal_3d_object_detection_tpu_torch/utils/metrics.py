"""Detection metrics: center-distance mAP + simplified NDS (host numpy).

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/utils/metrics.py:32-256``,
itself a port of the reference metric stack (ref: utils_v2.py):

- per-sample, per-class greedy score-ordered matching at a 2.0 m BEV
  center-distance threshold (utils_v2.py:13-36), one pass shared by the AP
  and the error terms;
- 11-point interpolated AP (utils_v2.py:42-88);
- mAP = mean over the 10 classes of per-sample AP means (utils_v2.py:177-184);
- simplified NDS = mean([5*mAP, 1-min(mATE/4,1), 1-min(mASE,1),
  1-min(mAOE/pi,1)]) with unmatched-empty error terms 1.0
  (utils_v2.py:189-199), not the official nuScenes NDS;
- quirk Q9: per-class rows in the reference's report order
  (`report_class_order="reference"`) or the label order (``"dataset"``);
- `save_and_print_metrics`: the reference's report text.

`compute_metrics_official` comes with ``eval.py`` (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..config import DEFAULT_CLASSES, METRIC_REPORT_CLASSES


def compute_center_distance_matrix(
    pred_boxes: np.ndarray, gt_boxes: np.ndarray
) -> np.ndarray:
    """(N, >=2) x (M, >=2) -> (N, M) BEV center distances
    (ref: utils_v2.py:7-10)."""
    d = pred_boxes[:, None, :2] - gt_boxes[None, :, :2]
    return np.sqrt((d * d).sum(axis=2))


def _greedy_tp_and_matches(
    distance_matrix: np.ndarray,
    pred_scores: np.ndarray,
    threshold: float,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """ONE greedy score-descending pass shared by AP and the error terms.

    Exact reference semantics (utils_v2.py:13-36 and 42-73 run the SAME
    greedy — each sorted prediction takes the nearest still-unmatched GT
    within `threshold`): returns (tp flags aligned to the sorted order,
    matches as (original_pred_idx, gt_idx)).

    Vectorized pre-filter: a prediction farther than `threshold` from EVERY
    GT can never match regardless of taken-state, so it is a guaranteed FP
    and skips the sequential loop entirely — in the production regime
    (top-K=100 decode, few GTs per class) that removes almost all Python
    iterations without changing a single assignment.
    """
    n, m = distance_matrix.shape
    order = np.argsort(-pred_scores)
    d = distance_matrix[order]
    tp = np.zeros(n)
    matches: List[Tuple[int, int]] = []
    if m == 0:
        return tp, matches
    taken = np.zeros(m, dtype=bool)
    for i in np.flatnonzero(d.min(axis=1) <= threshold):
        dist = np.where(taken, np.inf, d[i])
        gi = int(np.argmin(dist))
        if dist[gi] <= threshold:
            tp[i] = 1.0
            taken[gi] = True
            matches.append((int(order[i]), gi))
            if len(matches) == m:
                break
    return tp, matches


def _ap_from_tp(tp: np.ndarray, num_gt: int) -> float:
    """11-point interpolated AP from sorted-order tp flags
    (ref: utils_v2.py:74-88), vectorized: `recalls` is nondecreasing, so
    `precisions[recalls >= t].max()` equals the precision suffix-max at the
    first index where recall reaches t."""
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(1.0 - tp)
    recalls = tp_cum / num_gt
    precisions = tp_cum / (tp_cum + fp_cum + 1e-10)
    suffix_max = np.maximum.accumulate(precisions[::-1])[::-1]
    idx = np.searchsorted(recalls, np.linspace(0, 1, 11), side="left")
    inside = idx < len(recalls)
    vals = np.where(inside, suffix_max[np.minimum(idx, len(recalls) - 1)], 0.0)
    return float(vals.sum() / 11.0)


def compute_metrics(
    predictions: List[Dict],
    ground_truths: List[Dict],
    num_classes: int = 10,
    distance_threshold: float = 2.0,
    report_class_order: str = "reference",
) -> Dict[str, object]:
    """mAP + simplified NDS over per-sample prediction/GT dicts
    (ref: utils_v2.py:94-205).

    Each predictions[i]: {'boxes': (N,7), 'scores': (N,), 'labels': (N,)};
    each ground_truths[i]: {'boxes': (M,7), 'labels': (M,)} (-1 = padding).
    """
    class_names = (
        list(METRIC_REPORT_CLASSES)
        if report_class_order == "reference"
        else list(DEFAULT_CLASSES)
    )

    aps_per_class: Dict[int, List[float]] = {c: [] for c in range(num_classes)}
    mates: List[float] = []
    mases: List[float] = []
    maoes: List[float] = []

    for pred, gt in zip(predictions, ground_truths):
        pred_boxes = np.asarray(pred["boxes"])
        pred_scores = np.asarray(pred["scores"])
        pred_labels = np.asarray(pred["labels"])
        gt_boxes = np.asarray(gt["boxes"])
        gt_labels = np.asarray(gt["labels"])

        keep = gt_labels >= 0
        gt_boxes = gt_boxes[keep]
        gt_labels = gt_labels[keep]

        if len(gt_boxes) == 0 and len(pred_boxes) == 0:
            continue

        for cls in range(num_classes):
            cls_preds = pred_boxes[pred_labels == cls]
            cls_scores = pred_scores[pred_labels == cls]
            cls_gts = gt_boxes[gt_labels == cls]

            if len(cls_gts) == 0 and len(cls_preds) == 0:
                continue
            if len(cls_gts) == 0 or len(cls_preds) == 0:
                aps_per_class[cls].append(0.0)
                continue

            dist_mat = compute_center_distance_matrix(cls_preds, cls_gts)
            # one greedy pass feeds BOTH the AP and the error terms: the
            # reference runs the identical matching twice (calculate_ap at
            # utils_v2.py:42-73, match_predictions_to_gt at :13-36)
            tp, matches = _greedy_tp_and_matches(
                dist_mat, cls_scores, distance_threshold
            )
            aps_per_class[cls].append(_ap_from_tp(tp, len(cls_gts)))

            if matches:
                mp = np.fromiter((p for p, _ in matches), np.intp)
                mg = np.fromiter((g for _, g in matches), np.intp)
                pb, gb = cls_preds[mp], cls_gts[mg]
                mates.extend(
                    np.linalg.norm(pb[:, :2] - gb[:, :2], axis=1).tolist()
                )
                mases.extend(
                    np.mean(
                        np.abs(pb[:, 3:6] - gb[:, 3:6]) / (gb[:, 3:6] + 1e-6),
                        axis=1,
                    ).tolist()
                )
                ang = pb[:, 6] - gb[:, 6]
                maoes.extend(
                    np.abs(np.arctan2(np.sin(ang), np.cos(ang))).tolist()
                )

    class_aps = [
        float(np.mean(aps_per_class[c])) if aps_per_class[c] else 0.0
        for c in range(num_classes)
    ]
    m_ap = float(np.mean(class_aps))

    m_ate = float(np.mean(mates)) if mates else 1.0
    m_ase = float(np.mean(mases)) if mases else 1.0
    m_aoe = float(np.mean(maoes)) if maoes else 1.0

    nds = float(
        np.mean(
            [
                5 * m_ap,
                1 - min(m_ate / 4.0, 1.0),
                1 - min(m_ase / 1.0, 1.0),
                1 - min(m_aoe / np.pi, 1.0),
            ]
        )
    )

    return {
        "mAP": m_ap,
        "NDS": nds,
        "mATE": m_ate,
        "mASE": m_ase,
        "mAOE": m_aoe,
        "AP_per_class": {
            class_names[i]: class_aps[i] for i in range(num_classes)
        },
    }


def save_and_print_metrics(
    metrics: dict, save_path: str = "metrics_output.txt"
) -> None:
    """Write + print the exact reference report format
    (ref: utils_v2.py:208-233)."""
    lines = [
        "===== Evaluation Metrics =====",
        f"mAP : {metrics['mAP']:.4f}",
        f"NDS : {metrics['NDS']:.4f}",
        "",
        "--- AP Per Class ---",
    ]
    for cls_name, ap_val in metrics["AP_per_class"].items():
        lines.append(f"{cls_name:20s}: {ap_val:.4f}")

    print("\n" + lines[0])
    for line in lines[1:]:
        print(line)

    with open(save_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nMetrics saved to {save_path}")
