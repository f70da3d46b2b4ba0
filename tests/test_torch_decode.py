"""CenterNet decode and host post-processing in the PyTorch port against the
JAX package. The heatmap holds distinct random values, so every peak the
two-stage top-K keeps has a distinct score and tie-breaking plays no part:
the outputs must agree to f32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.ops import decode as jax_decode
from bevfusion_multimodal_3d_object_detection_tpu.ops import preprocess as jax_pre
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import decode as port_decode
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import preprocess as port_pre


def _maps(seed, b=2, h=32, w=32, c=10):
    rng = np.random.RandomState(seed)
    heat = rng.permutation(b * h * w * c).reshape(b, h, w, c).astype(np.float32)
    return {
        "heatmap": heat / heat.size,  # distinct values in [0, 1)
        "offset": rng.rand(b, h, w, 2).astype(np.float32),
        "size": rng.uniform(1, 5, (b, h, w, 3)).astype(np.float32),
        "rot": rng.randn(b, h, w, 2).astype(np.float32),
        "vel": rng.randn(b, h, w, 2).astype(np.float32),
    }


@pytest.mark.parametrize("class_always_zero", [True, False], ids=["Q1", "real-classes"])
@pytest.mark.parametrize("voxel_size", [0.512, (3.2, 1.6)], ids=["scalar", "per-axis"])
def test_decode_matches_jax(class_always_zero, voxel_size):
    maps = _maps(0)
    kw = dict(max_detections=100, voxel_size=voxel_size, class_always_zero=class_always_zero)
    want = jax_decode.decode_centernet_predictions(
        {k: jnp.asarray(v) for k, v in maps.items()}, **kw
    )
    got = port_decode.decode_centernet_predictions(
        {k: torch.from_numpy(v) for k, v in maps.items()}, **kw
    )
    for k in ("scores", "labels", "boxes", "velocities"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    assert got["labels"].dtype == torch.int32
    if class_always_zero:
        assert torch.all(got["labels"] == 0)
    else:
        assert len(torch.unique(got["labels"])) > 1


def test_heatmap_nms_matches_jax():
    heat = _maps(1)["heatmap"]
    want = np.asarray(jax_decode.heatmap_nms(jnp.asarray(heat)))
    got = port_decode.heatmap_nms(torch.from_numpy(heat).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("nms_thresh,cap", [(None, None), (0.3, 5)])
def test_decode_to_host_matches_jax(nms_thresh, cap):
    maps = _maps(2, h=16, w=16)
    kw = dict(max_detections=40, voxel_size=0.512)
    want = jax_decode.decode_to_host(
        jax_decode.decode_centernet_predictions({k: jnp.asarray(v) for k, v in maps.items()}, **kw),
        score_thresh=0.5, nms_thresh=nms_thresh, max_detections=cap,
    )
    got = port_decode.decode_to_host(
        port_decode.decode_centernet_predictions({k: torch.from_numpy(v) for k, v in maps.items()}, **kw),
        score_thresh=0.5, nms_thresh=nms_thresh, max_detections=cap,
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=k)


def test_bev_iou_and_nms_match_jax():
    rng = np.random.RandomState(3)
    boxes = np.concatenate(
        [rng.uniform(-5, 5, (30, 3)), rng.uniform(1, 4, (30, 3)), rng.randn(30, 1)], axis=1
    ).astype(np.float32)
    np.testing.assert_allclose(
        port_decode.bev_iou_matrix(boxes, boxes[:7]), jax_decode.bev_iou_matrix(boxes, boxes[:7])
    )
    det = {"boxes": boxes, "scores": rng.rand(30).astype(np.float32),
           "labels": np.zeros(30, np.int64)}
    got, want = port_decode.nms_bev(det, 0.2), jax_decode.nms_bev(det, 0.2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("src", [(32, 64), (48, 40)], ids=["same-size", "resized"])
def test_normalize_images_matches_jax(src):
    imgs = np.random.RandomState(4).randint(0, 256, (2, 3) + src + (3,), np.uint8)
    want = np.asarray(jax_pre.normalize_images(jnp.asarray(imgs), size=(32, 64)))
    got = port_pre.normalize_images(torch.from_numpy(imgs), size=(32, 64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
