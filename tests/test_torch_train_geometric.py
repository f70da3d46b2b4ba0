"""The port's train step on the geometric camera-to-BEV (``splat_mode:
pallas`` with chunk plans in the batch, which training ignores: it takes the
matmul splat, in both packages) against the JAX package's `make_train_step`,
as test_torch_train.py does for the pseudo camera-to-BEV: float cameras and
7-column boxes here."""

import pytest
import torch

from torch_train_helpers import check_step, train_runs


@pytest.fixture(scope="module")
def runs():
    return train_runs("geometric")


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_geometric_train_step_matches_jax(runs, step):
    check_step(runs, step)


def test_geometric_f32_steps_match_jax_train_step(runs):
    """Both steps in f32, each from the reference's state before it."""
    for step in (0, 1):
        check_step(runs, step, torch.float32)
