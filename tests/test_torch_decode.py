"""CenterNet decode and host post-processing in the PyTorch port against the
JAX package. The heatmap holds distinct random values, so every peak the
two-stage top-K keeps has a distinct score and tie-breaking plays no part:
the outputs must agree to f32 rounding. Then the port's one seam between a
batch and the detector: the keys a model reads, its forward's arguments,
the decoder the server, the engine and the eval step share, and the host
post-processing of `_fetch` and `decode_to_host`."""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plan_feed_helpers as pf
from bevfusion_multimodal_3d_object_detection_tpu.ops import decode as jax_decode
from bevfusion_multimodal_3d_object_detection_tpu.ops import preprocess as jax_pre
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.inference_engine import InferenceEngine
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import decode as port_decode
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import preprocess as port_pre
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import make_eval_step
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.restore import load_serving_variables


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


# -- the seam between a batch and the detector ---------------------------------

_PLANS = {"cells": ("camera_cells",), "chunks": ("camera_point_idx", "camera_local_ids", "camera_block_idx"),
          "pairs": ("camera_seg_idx", "camera_seg_id", "camera_pair_cell", "camera_pair_pix")}
# (splat mode, training, the plans in the batch, the plans the model reads)
_READS = [
    ("pallas", False, ("cells", "chunks"), "chunks"),
    ("pallas", True, ("cells", "chunks"), "cells"),
    ("pallas", False, ("cells",), "cells"),
    ("pallas", False, ("chunks",), "chunks"),
    ("culled", False, ("cells", "pairs"), "pairs"),
    ("culled", True, ("cells", "chunks", "pairs"), "pairs"),
    ("culled", True, ("cells",), "cells"),
    ("matmul", False, ("cells", "chunks", "pairs"), "cells"),
    ("matmul", True, ("chunks",), None),
    ("pseudo", False, ("cells", "chunks", "pairs"), None),
]


def _narrow_config(**compat):
    """base.yaml at test size, radar only, with `compat` flags and an
    ``inference.post_processing`` block of its own."""
    cfg = port_config.load_config(str(pathlib.Path(__file__).parents[1] / "configs" / "base.yaml"))
    model = cfg["model"]
    model["modality_config"] = "radar"
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    cfg.setdefault("compat", {}).update(compat)
    cfg["inference"]["post_processing"] = {"score_threshold": 0.2, "nms_threshold": 0.3, "max_detections": 5}
    return cfg


def _sample(spec, seed=0):
    rng = np.random.RandomState(seed)
    return {"camera_imgs": rng.randint(0, 256, (6,) + spec.camera.image_size + (3,)).astype(np.uint8),
            "lidar_points": rng.randn(spec.lidar.max_points, 4).astype(np.float32),
            "radar_points": rng.randn(5, spec.radar.max_points_per_sensor, 7).astype(np.float32)}


def _check_reads():
    for mode, training, present, read in _READS:
        spec = pf.spec("pallas" if mode == "pseudo" else mode)
        if mode == "pseudo":
            spec = dataclasses.replace(spec, use_lidar=False, bev=dataclasses.replace(spec.bev, camera_to_bev="pseudo"))
        model = MultiModal3DDetector(spec).train(training)
        batch = dict.fromkeys(("camera_imgs", "lidar_points", "radar_points", "gt_boxes")
                              + sum((_PLANS[p] for p in present), ()))
        inputs = ("camera_imgs", "radar_points") if mode == "pseudo" else ("camera_imgs", "lidar_points", "radar_points")
        assert model.reads(batch) == inputs + (_PLANS[read] if read else ()), (mode, training, present)
    # the forward's arguments: the uint8 wire normalized, the chunk plans as one tuple
    model = pf.model("pallas").eval()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in port_dataset.collate_fn(pf.samples((5,) * 2, {})).items()}
    args = model.forward_inputs(batch)
    assert list(args) == ["camera_imgs", "lidar_points", "radar_points", "camera_chunks"]
    assert torch.equal(args["camera_imgs"], port_pre.normalize_images(batch["camera_imgs"], size=(32, 64)))
    assert all(a is batch[k] for a, k in zip(args["camera_chunks"], _PLANS["chunks"]))


def _check_decode(q3):
    """The server, the engine and the eval step (on the eval path and off
    it) decode the same maps, each at its voxel: 0.512 on the eval path
    under Q3, else the grid's 6.4 m."""
    cfg = _narrow_config(eval_decode_voxel_0512=q3)
    spec, compat = port_config.DetectorSpec.from_config(cfg), port_config.CompatFlags.from_config(cfg)
    sample = _sample(spec)
    maps, got = {}, {}

    def seen(name):
        return lambda module, args, out: maps.__setitem__(name, out)

    server = InferenceServer(config=cfg, batch_size=1, score_threshold=0.0, use_bf16=False, fold_bn=False,
                             device="cpu")
    server.model.register_forward_hook(seen("server"))
    got["server"] = server._serve(*server._stage([sample])[1][0])
    engine = InferenceEngine(config=cfg, fold_bn=False, device="cpu")
    engine.init_random()
    engine.model.register_forward_hook(seen("engine"))
    got["engine"] = engine._forward(sample)[1]
    model = MultiModal3DDetector(spec, mask_padding=not compat.unmasked_point_padding)
    load_jax_variables(model, load_serving_variables(spec))
    model.register_forward_hook(lambda module, args, out: maps.__setitem__("eval", out))
    for eval_path in (False, True):
        step = make_eval_step(model, compat, max_detections=spec.centernet.max_detections,
                              eval_path_decode=eval_path, device="cpu")
        got[f"eval_step{int(eval_path)}"] = step(port_dataset.collate_fn([sample]))
        maps[f"eval_step{int(eval_path)}"] = maps.pop("eval")
    grid = (102.4 / 16, 102.4 / 16)
    voxels = {"server": 0.512 if q3 else grid, "engine": 0.512 if q3 else grid, "eval_step0": grid,
              "eval_step1": 0.512 if q3 else grid}
    for name, voxel in voxels.items():
        assert all(torch.equal(maps[name][k], maps["server"][k]) for k in maps["server"]), name
        want = port_decode.decode_centernet_predictions(
            maps["server"], max_detections=spec.centernet.max_detections, voxel_size=voxel,
            pc_range=spec.bev.pc_range, class_always_zero=compat.decode_class_always_zero)
        assert got[name].keys() == want.keys() and all(torch.equal(got[name][k], want[k]) for k in want), name


def _check_host(gate):
    """The server's `_fetch` and `decode_to_host` keep the same detections
    under the post-processing the resolver gives the server and the engine
    alike: the constructor's threshold alone with the gate closed, the
    config's block (threshold, BEV NMS, cap) with it open."""
    cfg = _narrow_config(ignore_post_processing_config=not gate)
    server = InferenceServer(config=cfg, batch_size=2, score_threshold=0.5, use_bf16=False, device="cpu")
    pp = server.post_process
    assert pp == InferenceEngine(config=cfg, score_threshold=0.5, device="cpu").post_process
    assert pp == (port_config.PostProcessSpec(0.2, 0.3, 5) if gate else port_config.PostProcessSpec(0.5, None, None))
    decoded = port_decode.decode_centernet_predictions(
        {k: torch.from_numpy(v) for k, v in _maps(5, h=16, w=16).items()}, max_detections=40, voxel_size=0.512)
    got = server._fetch([(decoded, None)], 2)
    want = port_decode.decode_to_host(decoded, score_thresh=pp.score_threshold, nms_thresh=pp.nms_threshold,
                                      max_detections=pp.max_detections)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["boxes"], np.concatenate([w["boxes"], w["velocities"]], axis=-1))
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert g["labels"].dtype == np.int64
        # open: capped after NMS; closed: every score above the threshold
        assert len(w["scores"]) == (5 if gate else int((decoded["scores"][i] > 0.5).sum()))


@pytest.mark.parametrize("case", ["reads", "decode_q3", "decode_grid", "host_gate_closed", "host_gate_open"])
def test_one_seam_between_a_batch_and_the_detector(case):
    """What the model reads of a batch (`MultiModal3DDetector.reads`, in
    train and eval mode, with and without each plan) and how it becomes the
    forward's arguments; one decoder (`centernet_decoder`) for the server,
    the engine and the eval step; one host filter (`filter_detections`) and
    one post-processing resolver (`PostProcessSpec.resolve`) for `_fetch`
    and `decode_to_host`."""
    if case == "reads":
        _check_reads()
    elif case.startswith("decode"):
        _check_decode(q3=case == "decode_q3")
    else:
        _check_host(gate=case == "host_gate_open")
