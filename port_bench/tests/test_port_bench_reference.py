"""The plain reference agrees with the program at a small size on the CPU:
the forward maps of both camera paths, and the first train steps."""

import pytest
import torch

import tiny
from core import common, harness, inputs
from core.harness import Context, jax_tree
from reference.geometry import frustum_cells


def _program_maps(cfg, variables, samples, cells=None, fold_bn=False):
    from bevfusion_multimodal_3d_object_detection_tpu_torch.config import DetectorSpec
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import normalize_images
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.fold_bn import fold_camera_variables

    spec = DetectorSpec.from_config(cfg)
    tree = jax_tree(variables)
    model = MultiModal3DDetector(spec, fold_bn=fold_bn)
    load_jax_variables(model, fold_camera_variables(tree) if fold_bn else tree)
    cams, lidar, radar = common.sample_tensors(samples, "cpu")
    kwargs = {} if cells is None else {"camera_cells": torch.as_tensor(cells)[None].expand(len(samples), -1, -1, -1, -1)}
    with torch.no_grad():
        return model.eval()(normalize_images(cams, size=tuple(cfg["model"]["camera_encoder"]["input_size"])),
                            lidar, radar, **kwargs)


@pytest.mark.parametrize("name,fold_bn", [("bevfusion_base", False), ("bevfusion_base", True),
                                          ("bevfusion_geometric", False)])
def test_forward_maps_agree(name, fold_bn):
    cfg = tiny.config(name)
    ctx = Context("t", {"traffic": {}}, cfg, 11, 1.0, False, torch.device("cpu"))
    spec = ctx.spec
    pool = inputs.samples(spec, 3, 11, "cpu", [40, 64], [2, 8])
    cells = frustum_cells(spec, inputs.ring_calibration(spec)) if name.endswith("geometric") else None
    cells_t = None if cells is None else torch.from_numpy(cells)
    variables = common.make_weights(ctx, pool, cells_t)
    want = common.reference_maps(spec, variables, pool, "cpu", cells=cells_t)
    got = _program_maps(cfg, variables, pool, cells, fold_bn)
    for k in want[0]:
        w = torch.stack([m[k] for m in want])
        err = float((got[k].float() - w).abs().max()) / max(float(w.abs().max()), 1e-6)
        assert err < 1e-4, (k, err)


def test_train_steps_agree():
    r = harness.run_cell("train_base_b4", 5, 0.5, False, "cpu", config=tiny.config("bevfusion_base"),
                         traffic=tiny.TRAFFIC)
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["loss_gap"] < 1e-4 and c["grad_gap"] < 1e-2 and c["change_gap"] < 5e-2, c
