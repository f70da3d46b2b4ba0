"""The Swin eval cell's own pieces: its counts against hand-worked figures,
its driver at a small size on the CPU (sound runs correct; the control, the
harness's faults and the two faults of the camera stream's mechanism not),
its readers reading none without their spans, and its check of what the
program built."""

import copy
import sys

import pytest

from core import counts_swint, harness, registry
from reference.swint_lss import Spec

BENCH = registry.benchmark()
CELL = "eval_swint_lss_b4"
FULL = Spec(registry.config(BENCH, "bevfusion_swint_lss"))
TRAFFIC = {"lidar_real": [40, 64], "radar_real": [2, 8], "batch_size": 2, "batches": 2, "check_samples": 4,
           "trace_steps": 2}
# At this size a sound run reads ~0 and the bf16 control 0.11-0.25 (seeds 11-13, 21-23): the cell's own
# limit, 0.25, is set at its full size, where the control reads 0.52 or more (PERF.md, section 2)
LIMITS = {"det_gap": 0.05}
NEW_METRICS = ("camera_ms.swint", "lift_ms.swint")
CELL_METRICS = {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", ())}
PROFILING = "bevfusion_multimodal_3d_object_detection_tpu_torch.utils.profiling"


def tiny_config() -> dict:
    """The configuration at 64x128 cameras, Swin widths 32-256, a 24x24
    camera grid of 8 channels onto 12x12, 8 depth bins, short point chains."""
    cfg = copy.deepcopy(registry.config(BENCH, "bevfusion_swint_lss"))
    m, d = cfg["model"], cfg["dataset"]
    d["cameras"]["image_size"] = m["camera_encoder"]["input_size"] = [64, 128]
    m["camera_encoder"]["swin"].update(embed_dim=32, depths=[2, 2, 2, 2], num_heads=[2, 4, 4, 8])
    m["camera_encoder"]["output_channels"] = 32
    m["bev_fusion"].update(depth_bins=8, camera_bev_channels=8, bev_h=12, bev_w=12, bev_channels=16)
    d["bev_h"] = d["bev_w"] = 12
    m["centernet_head"].update(in_channels=16, head_conv=8)
    d["max_points"] = {"lidar": 64, "radar_per_sensor": 8}
    m["lidar_encoder"].update(max_points=64, mlp_layers=[16, 32], feature_dim=32)
    m["radar_encoder"].update(max_points_per_sensor=8, mlp_layers=[8, 16], feature_dim=16)
    return cfg


def test_swin_block_by_hand():
    # stage 0 of Swin-T at 64x176 tokens, 96 channels, padded to 70x182 for the windows
    padded, real = 70 * 182, 64 * 176
    attention = 2 * padded * (3 * 96 * 96 + 2 * 49 * 96 + 96 * 96)
    mlp = 2 * real * 2 * 96 * 384
    assert counts_swint.swin_block_flops(64, 176, 96, 7, 4.0) == attention + mlp
    assert counts_swint.swin_block_flops(8, 22, 768, 7, 4.0) == 2 * 14 * 28 * (4 * 768 * 768 + 2 * 49 * 768) + \
        2 * 8 * 22 * 2 * 768 * 3072


def test_full_size_counts():
    assert FULL.feature_hw == (32, 88) and (FULL.cam_h, FULL.cam_w, FULL.cam_c) == (360, 360, 80)
    # 24 camera rows of 2,816 pixels x 118 bins onto 129,600 cells of 80 f32 channels
    assert counts_swint.b2_bytes(FULL, 4, 4) == pytest.approx(1137.7e6, rel=1e-4)
    swin = counts_swint.swin_flops(FULL)
    assert 35e9 < swin < 40e9  # Swin-T at 256x704: ~9 GFLOP at 224x224, 3.6x the pixels and the pads
    assert 650e9 < counts_swint.model_flops(FULL) < 750e9


@pytest.mark.parametrize("faults", [(), ("control",), ("half_batch",), ("answer_altered",), ("no_shift_mask",),
                                    ("no_rel_bias",)], ids=lambda f: "+".join(f) or "sound")
def test_correct_only_when_sound(faults):
    r = harness.run_cell(CELL, 2**31 + 91, 1.0, False, "cpu", config=tiny_config(), traffic=TRAFFIC, faults=faults,
                         limits=LIMITS)
    assert r["correct"] is (not faults), r["checks"]
    assert set(r["metrics"]) == {"eval_samples_per_s", "setup_s"}


def test_traced_run_reads_the_span_metrics():
    r = harness.run_cell(CELL, 2**31 + 92, 6.0, True, "cpu", config=tiny_config(), traffic=TRAFFIC, limits=LIMITS)
    assert r["correct"], r["checks"]
    # the stream times and the kernels' metrics need CUDA; the host-clock ones read here
    assert {"h2d_mb.eval", "eval_mfu", "inputs_ms.eval"} <= set(r["metrics"]) - {"eval_samples_per_s", "setup_s"} \
        <= CELL_METRICS


def test_readers_read_none_without_their_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)  # the import fails, as the parent's would
    for name in NEW_METRICS:
        assert registry.reader(name).read(None, {}) is None, name


def test_a_program_without_the_swin_stream_fails_at_set_up():
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import DetectorSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector

    driver = registry.driver("eval_swint")
    cfg = tiny_config()
    driver.check_program(MultiModal3DDetector(DetectorSpec.from_config(cfg)), Spec(cfg))
    bare = copy.deepcopy(cfg)  # what a program that ignores the camera stream's keys reads
    bare["model"]["camera_encoder"].update(backbone="resnet18", output_channels=512)
    del bare["model"]["bev_fusion"]["camera_bev_channels"]
    with pytest.raises(RuntimeError, match="asks for Swin and 8 channels"):
        driver.check_program(MultiModal3DDetector(DetectorSpec.from_config(bare)), Spec(cfg))
