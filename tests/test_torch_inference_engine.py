"""The port's InferenceEngine (on the CPU) against the JAX package's, both
restoring one msgpack checkpoint of seeded random weights at test width
(tri-modal, 32x64 cameras, 256 LiDAR and 16 radar points, a 16x16 BEV).

Tolerances: the prediction maps and the decoded scores and boxes agree
within 1e-4 of each output's largest magnitude. The port folds the point
encoders' BatchNorms into B1's weights (its plain version here) and JAX
runs them unfolded, so the f32 results differ by rounding. Decoded entries
are compared sorted by position, since two close scores may come out of
top-k in either order. A detection whose score lies within that tolerance
of the 0.3 threshold could be kept by one side only; the test asserts that
its sample has none, so the thresholded lists, P/R/F1 and the predictions
JSON must agree exactly in count and label (floats within the tolerance)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from bevfusion_multimodal_3d_object_detection_tpu import inference_engine as jax_engine
from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec as JaxSpec
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.ops.decode import decode_centernet_predictions as jax_decode
from bevfusion_multimodal_3d_object_detection_tpu_torch import inference_engine as port_engine
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import NuScenesDataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.checkpoint import save_checkpoint
from torch_port_helpers import detector_inputs, random_variables
from torch_trainer_helpers import tree_config, write_test_tree

RTOL_SCALE = 1e-4
MAP_KEYS = ("heatmap", "offset", "size", "rot", "vel")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A nuScenes tree, its config, a checkpoint of seeded random weights,
    and one engine of each package restoring it."""
    import jax

    tmp = tmp_path_factory.mktemp("engine")
    data = write_test_tree(tmp / "data", samples_per_split=2, splits=("val",), radar_points=20)
    cfg = tree_config(tmp, data)
    cfg["inference"]["save_predictions"] = True
    spec = JaxSpec.from_config(cfg)
    args = tuple(jnp.asarray(a[:1]) for a in detector_inputs(spec, batch=1))
    init = JaxDetector(spec=spec).init({"params": jax.random.PRNGKey(0)}, *args)
    variables = random_variables(init, seed=11)
    # a head with spread scores and positive sizes, so that detections
    # cross the 0.3 threshold on both sides and match GT boxes by IoU
    head = variables["params"]["det_head"]
    head["heatmap_head"]["conv2"]["kernel"] *= 0.02
    head["heatmap_head"]["conv2"]["bias"][:] = -0.6
    head["size_head"]["conv2"]["kernel"] *= 0.02
    head["size_head"]["conv2"]["bias"][:] = (2.0, 4.0, 1.5)
    ckpt = tmp / "model.msgpack"
    save_checkpoint(str(ckpt), {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    ds = NuScenesDataset(split="val", config=cfg, seed=0)
    return {
        "tmp": tmp, "cfg": cfg, "ds": ds, "ckpt": ckpt,
        "jax": jax_engine.InferenceEngine(model_path=str(ckpt), config=cfg),
        "port": port_engine.InferenceEngine(model_path=str(ckpt), config=cfg, device="cpu"),
    }


def _boxes(rng, n):
    b = np.zeros((n, 7))
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 3:6] = rng.uniform(0.5, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("seed", range(4))
def test_iou_and_prf1_match_jax(seed):
    """Seeded boxes, some overlapping: IoU of every pair and greedy P/R/F1
    (with and without predictions or GT) equal the JAX functions'."""
    rng = np.random.RandomState(seed)
    preds, gts = _boxes(rng, 6), _boxes(rng, 5)
    preds[:3] = gts[:3] + rng.normal(0, 0.3, (3, 7))
    for a in preds:
        for b in gts:
            assert port_engine.bev_iou_axis_aligned(a, b) == jax_engine.bev_iou_axis_aligned(a, b)
    for p, g in ((preds, gts), (preds[:0], gts), (preds, gts[:0]), (preds[:0], gts[:0])):
        for thr in (0.1, 0.5):
            assert port_engine.precision_recall_f1(p, g, thr) == jax_engine.precision_recall_f1(p, g, thr)


def _by_position(dets):
    order = np.lexsort((dets["boxes"][:, 1], dets["boxes"][:, 0]))
    return {k: np.asarray(v)[order] for k, v in dets.items()}


def test_engine_matches_jax(setup, tmp_path):
    port, jx, ds = setup["port"], setup["jax"], setup["ds"]
    sample = ds[0]

    # the maps and the fixed-size decode before the threshold
    preds, decoded = port._forward(sample)
    want = jx._apply(jx.variables, *jx._inputs(sample, batch=True))
    for k in MAP_KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(preds[k].numpy(), w, rtol=0, atol=RTOL_SCALE * np.abs(w).max(), err_msg=k)
    want_dec = jax_decode(want, max_detections=jx.spec.centernet.max_detections, voxel_size=jx.voxel_size,
                          pc_range=jx.spec.bev.pc_range, class_always_zero=jx.compat.decode_class_always_zero)
    got_scores, want_scores = decoded["scores"][0].numpy(), np.asarray(want_dec["scores"][0])
    scale = np.abs(want_scores).max()
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=RTOL_SCALE * scale)
    # no decoded score at the 0.3 threshold within the tolerance
    assert np.abs(want_scores - 0.3).min() > RTOL_SCALE * scale
    real = want_scores > 0.0  # NMS zeros tie and come back in any order
    got = _by_position({k: decoded[k][0].numpy()[got_scores > 0.0] for k in ("boxes", "labels")})
    ref = _by_position({k: np.asarray(want_dec[k][0])[real] for k in ("boxes", "labels")})
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=0,
                               atol=RTOL_SCALE * np.abs(ref["boxes"]).max())
    np.testing.assert_array_equal(got["labels"], ref["labels"])

    # GT: three of the kept detections, slightly moved, and two far boxes
    kept = want_scores > 0.3
    assert kept.sum() >= 4
    rng = np.random.RandomState(3)
    gt = np.concatenate([np.asarray(want_dec["boxes"][0])[kept][:3] + rng.normal(0, 0.05, (3, 7)),
                         [[60, 60, -1, 2, 2, 2, 0], [-60, 60, -1, 2, 2, 2, 0]]]).astype(np.float32)
    sample = dict(sample, gt_boxes=gt, gt_labels=np.array([0, 1, 2, -1, 3]))
    res = port.run_inference(sample, visualize=False, save_dir=str(tmp_path / "port"))
    ref = jx.run_inference(sample, visualize=False, save_dir=str(tmp_path / "jax"))
    for k in ("precision", "recall", "f1", "tp", "fp", "fn"):
        assert res[k] == ref[k], k
    assert res["tp"] >= 3 and res["fn"] == 1  # the unlabelled box is not counted
    g, r = _by_position(res["detections"]), _by_position(ref["detections"])
    assert len(g["scores"]) == len(r["scores"]) == kept.sum()
    for k in ("boxes", "scores", "velocities"):
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=RTOL_SCALE * max(np.abs(r[k]).max(), scale))
    np.testing.assert_array_equal(g["labels"], r["labels"])
    assert res["latency_s"] > 0

    # the predictions JSON: the same entries, in position order
    got_json = json.loads(open(res["predictions_path"]).read())
    want_json = json.loads(open(ref["predictions_path"]).read())
    assert got_json["token"] == want_json["token"] == sample["token"]

    def entries(payload):
        return sorted(payload["detections"], key=lambda d: (d["box"][0], d["box"][1]))

    for a, b in zip(entries(got_json), entries(want_json), strict=True):
        assert (a["label"], a["class"]) == (b["label"], b["class"])
        np.testing.assert_allclose(a["box"] + [a["score"]] + a["velocity"], b["box"] + [b["score"]] + b["velocity"],
                                   rtol=0, atol=RTOL_SCALE * max(np.abs(r["boxes"]).max(), 1.0))


def test_batch_inference_matches_jax(setup, tmp_path):
    """Micro-averaged P/R/F1 over both val samples (integer counts: equal),
    and one predictions JSON per sample."""
    port, jx, ds = setup["port"], setup["jax"], setup["ds"]
    got = port.batch_inference(ds, num_samples=5, save_dir=str(tmp_path / "port"))
    want = jx.batch_inference(ds, num_samples=5, save_dir=str(tmp_path / "jax"))
    timing = ("mean_latency_s", "samples_per_sec")
    assert {k: v for k, v in got.items() if k not in timing} == {k: v for k, v in want.items() if k not in timing}
    assert got["num_samples"] == 2 and got["samples_per_sec"] > 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_figure_is_written(setup, tmp_path):
    res = setup["port"].run_inference(setup["ds"][1], visualize=True, save_dir=str(tmp_path))
    path = tmp_path / f"inference_{setup['ds'][1]['token']}.png"
    assert res["figure_path"] == str(path)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and path.stat().st_size > 10_000


def test_engine_contract(setup):
    """No weights -> run_inference raises; init_random serves the seeded
    weights; a missing checkpoint raises unless strict=False; with fold_bn
    the camera BatchNorms fold after the restore (maps within 1e-4 of the
    unfolded engine's scale)."""
    cfg = setup["cfg"]
    folded = port_engine.InferenceEngine(model_path=str(setup["ckpt"]), config=cfg, fold_bn=True, device="cpu")
    assert "channel_proj_bn" not in folded.variables["params"]["camera_encoder"]
    assert "channel_proj_bn" in setup["port"].variables["params"]["camera_encoder"]
    got, _ = folded._forward(setup["ds"][0])
    want, _ = setup["port"]._forward(setup["ds"][0])
    for k in MAP_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=RTOL_SCALE * want[k].abs().max().item(), err_msg=k)
    engine = port_engine.InferenceEngine(config=cfg, device="cpu")
    with pytest.raises(RuntimeError, match="init_random"):
        engine.run_inference(setup["ds"][0], visualize=False)
    engine.init_random()
    assert np.isfinite(engine.run_inference(setup["ds"][0], visualize=False)["detections"]["boxes"]).all()
    missing = str(setup["tmp"] / "missing.msgpack")
    with pytest.raises(RuntimeError, match="failed to restore"):
        engine.load_model(missing)
    engine.load_model(missing, strict=False)
    assert engine.variables is not None


def test_geometric_config_raises(setup):
    """The JAX engine passes no frustum cells and silently runs the pseudo
    camera-to-BEV on a geometric config; the port's raises, naming that."""
    import copy

    cfg = copy.deepcopy(setup["cfg"])
    cfg["model"]["bev_fusion"]["camera_to_bev"] = "geometric"
    with pytest.raises(NotImplementedError, match="frustum cells.*pseudo.*ROADMAP C"):
        port_engine.InferenceEngine(config=cfg, device="cpu")
