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
- `match_predictions_to_gt` and `calculate_ap` (``:95-115``): the matching
  and the AP of one class of one sample on their own;
- `save_and_print_metrics`: the reference's report text;
- `compute_metrics_official` (``:258-440``): the official-style nuScenes
  protocol that ``metrics.use_official`` turns on in the eval CLI.
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


def match_predictions_to_gt(
    distance_matrix: np.ndarray,
    pred_scores: np.ndarray,
    threshold: float = 2.0,
) -> List[Tuple[int, int]]:
    """Greedy score-descending matching; each GT used once
    (ref: utils_v2.py:13-36)."""
    return _greedy_tp_and_matches(distance_matrix, pred_scores, threshold)[1]


def calculate_ap(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    gt_boxes: np.ndarray,
    distance_matrix: np.ndarray,
    threshold: float = 2.0,
) -> float:
    """11-point interpolated AP with greedy TP assignment
    (ref: utils_v2.py:42-88)."""
    if len(pred_boxes) == 0 or len(gt_boxes) == 0:
        return 0.0
    tp, _ = _greedy_tp_and_matches(distance_matrix, pred_scores, threshold)
    return _ap_from_tp(tp, len(gt_boxes))


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


# ---------------------------------------------------------------------------
# Official-style nuScenes metrics (metrics.use_official)
# ---------------------------------------------------------------------------


def _class_sample_data(predictions, ground_truths, cls):
    """Per-sample data of one class, shared by every distance threshold:
    score-sorted predictions, center-distance matrices and velocities."""
    data = []
    total_gt = 0
    for pred, gt in zip(predictions, ground_truths):
        gt_boxes = np.asarray(gt["boxes"])
        gt_labels = np.asarray(gt["labels"])
        keep = gt_labels >= 0
        gt_boxes, gt_labels = gt_boxes[keep], gt_labels[keep]
        sel = gt_labels == cls
        cls_gts = gt_boxes[sel]
        gt_vel = None
        if "velocities" in gt:
            gt_vel = np.asarray(gt["velocities"])[keep][sel]
        total_gt += len(cls_gts)

        p_mask = np.asarray(pred["labels"]) == cls
        cls_preds = np.asarray(pred["boxes"])[p_mask]
        cls_scores = np.asarray(pred["scores"])[p_mask]
        pred_vel = None
        if "velocities" in pred:
            pred_vel = np.asarray(pred["velocities"])[p_mask]
        order = np.argsort(-cls_scores)
        cls_preds, cls_scores = cls_preds[order], cls_scores[order]
        if pred_vel is not None:
            pred_vel = pred_vel[order]

        if len(cls_preds) and len(cls_gts):
            dists = np.hypot(
                cls_preds[:, None, 0] - cls_gts[None, :, 0],
                cls_preds[:, None, 1] - cls_gts[None, :, 1],
            )
        else:
            dists = np.zeros((len(cls_preds), len(cls_gts)))
        data.append((cls_preds, cls_scores, cls_gts, pred_vel, gt_vel, dists))
    return data, total_gt


def _global_class_matches(data, threshold):
    """Greedy score-ordered matching at one threshold (the official
    protocol; the reference averages per-sample APs instead). Rows of
    (score, is_tp, ate, ase, aoe, ave or None); ave is None when either
    side has no velocities, so mAVE stays at its worst value."""
    rows = []
    for cls_preds, cls_scores, cls_gts, pred_vel, gt_vel, dists in data:
        taken = np.zeros(len(cls_gts), dtype=bool)
        for pi in range(len(cls_preds)):
            best_gi = -1
            if len(cls_gts):
                masked = np.where(taken, np.inf, dists[pi])
                gi = int(np.argmin(masked))
                if masked[gi] <= threshold:
                    best_gi = gi
            if best_gi >= 0:
                taken[best_gi] = True
                pb, gb = cls_preds[pi], cls_gts[best_gi]
                # ASE = 1 - IoU of the size-aligned boxes, intersection over
                # union as the devkit's scale_iou
                inter = float(np.prod(np.minimum(pb[3:6], gb[3:6])))
                union = float(np.prod(pb[3:6]) + np.prod(gb[3:6]) - inter)
                iou = inter / max(union, 1e-9)
                ang = pb[6] - gb[6]
                aoe = abs(float(np.arctan2(np.sin(ang), np.cos(ang))))
                ave = None
                if pred_vel is not None and gt_vel is not None and len(gt_vel):
                    ave = float(np.linalg.norm(pred_vel[pi] - gt_vel[best_gi]))
                rows.append((cls_scores[pi], 1, float(dists[pi, best_gi]), 1 - iou, aoe, ave))
            else:
                rows.append((cls_scores[pi], 0, 0.0, 0.0, 0.0, None))
    return rows


def _official_ap(rows, total_gt, min_recall=0.1, min_precision=0.1):
    """nuScenes AP: 101-point interpolated precision without the operating
    points below 10 % recall or precision, normalized."""
    if total_gt == 0 or not rows:
        return 0.0
    rows = sorted(rows, key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in rows])
    fp = np.cumsum([1 - r[1] for r in rows])
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    r_grid = np.linspace(0, 1, 101)
    p_interp = np.interp(r_grid, recall, precision, right=0.0)
    sel = p_interp[int(round(100 * min_recall)) + 1:]
    sel = np.maximum(sel - min_precision, 0.0)
    return float(np.mean(sel) / (1.0 - min_precision))


def compute_metrics_official(
    predictions: List[Dict],
    ground_truths: List[Dict],
    num_classes: int = 10,
    dist_ths=(0.5, 1.0, 2.0, 4.0),
    tp_threshold: float = 2.0,
) -> Dict[str, object]:
    """Official-style nuScenes detection metrics:

    - AP per class averaged over the center-distance thresholds `dist_ths`
      (``metrics.nuscenes.dist_ths``);
    - global (cross-sample) precision/recall with 101-point interpolation
      and the 10 % recall and precision cutoffs;
    - TP errors (ATE/ASE/AOE/AVE) on the matches at `tp_threshold` (one more
      matching pass when it is not among `dist_ths`);
    - NDS = (5 mAP + sum(1 - min(1, mTP))) / 10 with mAAE at its worst value
      1.0 (no attributes are modelled), and mAVE 1.0 when neither side has
      velocities.

    AP_per_class is keyed in the label order (`DEFAULT_CLASSES`).
    """
    class_aps = []
    ates, ases, aoes, aves = [], [], [], []

    def collect(rows):
        for r in rows:
            if r[1] != 1:
                continue
            ates.append(r[2])
            ases.append(r[3])
            aoes.append(r[4])
            if r[5] is not None:
                aves.append(r[5])

    for cls in range(num_classes):
        data, total_gt = _class_sample_data(predictions, ground_truths, cls)
        th_aps = []
        tp_collected = False
        for th in dist_ths:
            rows = _global_class_matches(data, th)
            th_aps.append(_official_ap(rows, total_gt))
            if np.isclose(th, tp_threshold):
                collect(rows)
                tp_collected = True
        if not tp_collected:
            collect(_global_class_matches(data, tp_threshold))
        class_aps.append(float(np.mean(th_aps)))

    m_ap = float(np.mean(class_aps))
    m_ate = float(np.mean(ates)) if ates else 1.0
    m_ase = float(np.mean(ases)) if ases else 1.0
    m_aoe = float(np.mean(aoes)) if aoes else 1.0
    m_ave = float(np.mean(aves)) if aves else 1.0
    m_aae = 1.0  # attributes are not modelled

    tp_scores = [1 - min(1.0, m) for m in (m_ate, m_ase, m_aoe, m_ave, m_aae)]
    nds = float((5 * m_ap + sum(tp_scores)) / 10.0)
    return {
        "mAP": m_ap,
        "NDS": nds,
        "mATE": m_ate,
        "mASE": m_ase,
        "mAOE": m_aoe,
        "mAVE": m_ave,
        "mAAE": m_aae,
        "AP_per_class": {DEFAULT_CLASSES[i]: class_aps[i] for i in range(num_classes)},
    }
