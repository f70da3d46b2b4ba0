"""``camera_encoder.freeze_bn`` in the port's train step against the JAX
package's: the camera encoder's BatchNorms normalize with their running
statistics in training and never update them (JAX ``models/encoders.py:50-52``,
``bn_train = train and not freeze_bn``); every other BatchNorm trains.
Two steps against JAX's float64 steps at test_torch_train.py's limits, and
two consecutive steps of one model with ``eval()`` / ``train()`` between,
as the Trainer switches it around validation."""

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.models.encoders import ResNetCameraEncoder
from torch_train_helpers import (
    assert_step_matches,
    check_step,
    loss_keys,
    port_layout,
    port_record,
    port_step_from,
    state_dict_of,
    train_runs,
)


@pytest.fixture(scope="module")
def runs():
    return train_runs("freeze_bn")


def _camera_bn_stats(state):
    return {k: v for k, v in state.items()
            if k.startswith("camera_encoder.") and k.endswith(("running_mean", "running_var"))}


def test_jax_reference_freezes_the_camera_statistics(runs):
    """JAX's float64 steps leave the camera encoder's statistics as they
    were and move the fusion's and the head's."""
    spec, bs = runs["spec"], runs["variables"]["batch_stats"]
    before = state_dict_of(spec, runs["variables"]["params"], bs)
    after = port_layout(spec, runs["exact"][1], bs)["state"]
    frozen = _camera_bn_stats(before)
    assert len(frozen) == 2 * 16  # the trunk's 15 BatchNorms and channel_proj_bn
    for k in frozen:
        assert torch.equal(after[k], before[k]), k
    moved = [k for k in before if k.endswith("running_mean") and k not in frozen]
    assert moved and all(not torch.equal(after[k], before[k]) for k in moved)


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_freeze_bn_train_step_matches_jax(runs, step):
    check_step(runs, step)


def test_freeze_holds_across_mode_switches(runs):
    """One float64 model, two steps with eval() and train() between: the
    first step matches JAX's, the camera BatchNorms stay in eval mode while
    the rest trains, the second step's losses match JAX's second step and
    the camera statistics stay bit for bit."""
    spec, exact, bs = runs["spec"], runs["exact"], runs["variables"]["batch_stats"]
    model, opt, step = port_step_from(spec, runs["variables"], dtype=torch.float64, check_gradients=True)
    before = {k: v.clone() for k, v in _camera_bn_stats(model.state_dict()).items()}
    assert_step_matches(port_record(model, opt, step(runs["batches"][0])), port_layout(spec, exact[0], bs), None)
    model.eval()
    model.train()
    cam = model.camera_encoder
    assert isinstance(cam, ResNetCameraEncoder) and cam.training and cam.trunk.training
    bns = [m for m in cam.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert len(bns) == 16 and not any(m.training for m in bns)
    assert model.fusion.bev_fusion1_bn.training
    got = port_record(model, opt, step(runs["batches"][1]))
    for k, v in before.items():
        assert torch.equal(got["state"][k], v), k
    for k in loss_keys(exact[1]["losses"]):
        np.testing.assert_allclose(got["losses"][k], exact[1]["losses"][k], rtol=1e-5, err_msg=k)
