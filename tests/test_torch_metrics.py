"""The port's metrics against the JAX package's: the same predictions give
an identical metrics dict and an identical report file, in both class
orders (quirk Q9), the official-style metrics agree at 1e-12, and
`match_predictions_to_gt` and `calculate_ap` give identical matches and APs
(exact: the same numpy arithmetic) on seeded distance matrices, empty ones
included."""

import numpy as np
import pytest

from bevfusion_multimodal_3d_object_detection_tpu.utils import metrics as jax_metrics
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import metrics as port_metrics


def _case(seed=0, samples=6):
    """Per-sample predictions near (and some far from) padded GT rows, over
    all 10 classes; one sample with neither, one with GT only."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for i in range(samples):
        m = 0 if i == 0 else rng.randint(1, 8)
        boxes = np.zeros((10, 7), np.float32)
        labels = np.full(10, -1, np.int64)
        boxes[:m, :2] = rng.uniform(-40, 40, (m, 2))
        boxes[:m, 3:6] = rng.uniform(0.5, 4, (m, 3))
        boxes[:m, 6] = rng.uniform(-np.pi, np.pi, m)
        labels[:m] = rng.randint(0, 10, m)
        gts.append({"boxes": boxes, "labels": labels})
        if i == 1:
            preds.append({"boxes": np.zeros((0, 7), np.float32), "scores": np.zeros(0, np.float32),
                          "labels": np.zeros(0, np.int64)})
            continue
        near = boxes[:m] + rng.normal(0, 0.8, (m, 7)).astype(np.float32)
        far = np.concatenate([rng.uniform(-50, 50, (5, 2)), rng.uniform(0.5, 4, (5, 5))], 1).astype(np.float32)
        pb = np.concatenate([near, far])
        preds.append({"boxes": pb, "scores": rng.uniform(0, 1, len(pb)).astype(np.float32),
                      "labels": np.concatenate([labels[:m], rng.randint(0, 10, 5)])})
    return preds, gts


@pytest.mark.parametrize("order", ["reference", "dataset"])
def test_metrics_and_report_match_jax(order, tmp_path):
    preds, gts = _case()
    got = port_metrics.compute_metrics(preds, gts, num_classes=10, report_class_order=order)
    want = jax_metrics.compute_metrics(preds, gts, num_classes=10, report_class_order=order)
    assert got == want
    assert list(got["AP_per_class"]) == list(want["AP_per_class"])
    assert 0 < got["mAP"] < 1 and got["mATE"] < 1.0  # matches were made
    port_metrics.save_and_print_metrics(got, str(tmp_path / "port.txt"))
    jax_metrics.save_and_print_metrics(want, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def test_empty_predictions_give_the_degenerate_report():
    """No matches: error terms default to 1.0 (utils_v2.py:189-199)."""
    _, gts = _case(seed=1, samples=3)
    empty = [{"boxes": np.zeros((0, 7)), "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}] * 3
    got = port_metrics.compute_metrics(empty, gts)
    assert got == jax_metrics.compute_metrics(empty, gts)
    assert got["mAP"] == 0.0 and got["mATE"] == got["mASE"] == got["mAOE"] == 1.0


@pytest.mark.parametrize("velocities", [False, True])
@pytest.mark.parametrize("dist_ths,tp_threshold", [((0.5, 1.0, 2.0, 4.0), 2.0), ((1.0, 3.0), 2.0), ((0.5,), 0.5)])
def test_official_metrics_match_jax(dist_ths, tp_threshold, velocities):
    """`compute_metrics_official` against the JAX package's at 1e-12: the
    nuScenes thresholds, custom ones without `tp_threshold` among them (an
    extra matching pass), and with or without velocities on both sides
    (mAVE). Both report AP_per_class in the label order."""
    preds, gts = _case(seed=2, samples=8)
    if velocities:
        rng = np.random.RandomState(4)
        for p, g in zip(preds, gts):
            p["velocities"] = rng.randn(len(p["boxes"]), 2)
            g["velocities"] = rng.randn(len(g["boxes"]), 2)
    got = port_metrics.compute_metrics_official(preds, gts, dist_ths=dist_ths, tp_threshold=tp_threshold)
    want = jax_metrics.compute_metrics_official(preds, gts, dist_ths=dist_ths, tp_threshold=tp_threshold)
    assert list(got) == list(want) and list(got["AP_per_class"]) == list(want["AP_per_class"])
    for k, v in want.items():
        if k == "AP_per_class":
            np.testing.assert_allclose(list(got[k].values()), list(v.values()), rtol=0, atol=1e-12)
        else:
            assert abs(got[k] - v) <= 1e-12, k
    assert 0 < got["mAP"] < 1 and got["mATE"] < 1.0 and (got["mAVE"] != 1.0) == velocities


def _distances(seed, n, m):
    """(n, m) distances, a few under the 2 m threshold, with ties in score."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.0, 6.0, (n, m))
    scores = np.round(rng.uniform(0, 1, n), 1)  # ties: argsort's order decides
    return d, scores


@pytest.mark.parametrize("n,m", [(12, 5), (5, 12), (0, 4), (4, 0), (0, 0), (30, 30)])
@pytest.mark.parametrize("threshold", [2.0, 0.5])
def test_match_and_ap_match_jax(n, m, threshold):
    d, scores = _distances(n * 31 + m, n, m)
    pred_boxes, gt_boxes = np.zeros((n, 7)), np.zeros((m, 7))
    from bevfusion_multimodal_3d_object_detection_tpu_torch import utils as port_utils

    got = port_utils.match_predictions_to_gt(d, scores, threshold)
    assert got == jax_metrics.match_predictions_to_gt(d, scores, threshold)
    assert len({gi for _, gi in got}) == len(got)  # each GT used once
    ap = port_utils.calculate_ap(pred_boxes, scores, gt_boxes, d, threshold)
    assert ap == jax_metrics.calculate_ap(pred_boxes, scores, gt_boxes, d, threshold)
    if n == 0 or m == 0:
        assert got == [] and ap == 0.0
