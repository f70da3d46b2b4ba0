"""The PyTorch port's train step against the JAX package's `make_train_step`.

Narrow spec (tests/torch_port_helpers.py), seeded random variables carried
over by `load_jax_variables`, the default `TrainSpec` (AdamW lr 1e-4, wd
0.01, clip 10, Q6 constant rate) and compat flags, two batches of 2 samples
with uint8 cameras, 9-column boxes and padded rows (the geometric
camera-to-BEV: test_torch_train_geometric.py).

The reference is JAX's `make_train_step` computed exactly, in float64 and
un-jitted (tests/torch_train_helpers.py says why). Each port step runs, in
float64 and in f32, from the reference's state before that step (the
initial variables; then JAX's step-1 variables and AdamW moments) and is
held to the reference's step at the same fixed limits (an f32 step that
crossed a ReLU or max-pool tie, to the port's float64 step on its side of
the tie; `check_step`):

- each loss term: relative 1e-5; ``grad_norm`` (``check_gradients``):
  relative 1e-5 in float64 and, a gradient, 1e-4 in f32 (the first
  moments' limit);
- AdamW first moments (optax ``mu`` / torch ``exp_avg``): 1e-4 of each
  tensor's largest. A bias right before a BatchNorm has an exactly zero
  gradient (the reference's first moment is below 1e-9 of the largest
  anywhere); the port's is held below 1e-5 of the largest anywhere;
- BatchNorm ``running_var`` relative 1e-5, ``running_mean`` 1e-5 of the
  tensor's largest (a mean can be 0);
- parameters 1e-6 absolute, except where the gradient is below 1e-3 of its
  tensor's largest: there Adam follows the sign of a near-zero gradient, and
  the element is held within 2 lr.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.models.batch_norm import FlaxBatchNorm2d
from torch_train_helpers import (
    LR,
    LOSS_KEYS,
    TRAIN,
    check_step,
    first_moments,
    jax_steps,
    port_step_from,
    state_dict_of,
    train_runs,
)


@pytest.fixture(scope="module")
def runs():
    return train_runs("pseudo")


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_train_step_matches_jax(runs, step):
    check_step(runs, step)


def test_f32_steps_match_jax_train_step(runs):
    """Both steps in f32, each from the reference's state before it."""
    for step in (0, 1):
        check_step(runs, step, torch.float32)


def test_mixed_precision_step_matches_jax_bf16(runs):
    """`mixed_precision`: bf16 autocast over f32 parameters against JAX's
    model in bf16 (its dtype) over f32 parameters. The total loss is within
    3e-2 relative (found: 6.6e-5; the regression terms differ by up to
    1.8e-2; port_numerics.py); parameters and AdamW moments stay f32 and
    finite."""
    spec, variables, batch = runs["spec"], runs["variables"], runs["batches"][0]
    want = jax_steps(spec, variables, [batch], dtype=jnp.bfloat16)[0]["losses"]["total_loss"]
    model, opt, step = port_step_from(spec, variables, train_spec=dataclasses.replace(TRAIN, mixed_precision=True))
    got = float(step(batch)["total_loss"])
    assert abs(got - want) <= 3e-2 * abs(want), (got, want)
    for p in model.parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())
        state = opt.adamw.state[p]
        assert state["exp_avg"].dtype == torch.float32 and bool(torch.isfinite(state["exp_avg_sq"]).all())


def test_gradient_accumulation_matches_jax_multisteps(runs):
    """grad_accum_steps 2 against JAX's train step over optax.MultiSteps:
    parameters stay as they are after the first micro-batch in both; the
    second makes one update. The first micro-batch's losses match the
    reference's first step (1e-5 relative), the second's JAX's f32 run (1e-5
    relative). The update itself is held to optax.MultiSteps in
    tests/test_torch_optim.py."""
    spec, variables, batches, exact = runs["spec"], runs["variables"], runs["batches"], runs["exact"]
    train_spec = dataclasses.replace(TRAIN, grad_accum_steps=2)
    ref = jax_steps(spec, variables, batches, train_spec=train_spec)
    model, opt, step = port_step_from(spec, variables, train_spec=train_spec)
    start = {k: v.clone() for k, v in model.named_parameters()}
    for i, batch in enumerate(batches):
        losses = step(batch)
        for k in LOSS_KEYS:  # the parameters have not moved before either
            want = exact[0]["losses"][k] if i == 0 else ref[i]["losses"][k]
            assert abs(float(losses[k]) - want) <= 1e-5 * abs(want), (i, k)
        jax_params = state_dict_of(spec, ref[i]["variables"]["params"], variables["batch_stats"])
        moved = {n: not torch.equal(p, start[n]) for n, p in model.named_parameters()}
        jax_moved = {n: not torch.equal(jax_params[n].float(), start[n]) for n in moved}
        if i == 0:
            assert opt.updates == 0 and opt.mini_step == 1
            assert not any(moved.values()) and not any(jax_moved.values())
        else:
            assert opt.updates == 1 and opt.mini_step == 0 and step.step == 2
            assert all(jax_moved.values()) and all(moved.values())
            for n, p in model.named_parameters():  # one AdamW step: at most lr (1 + wd |p|) each
                bound = LR * (1 + TRAIN.weight_decay * start[n].abs()) * (1 + 1e-3)
                assert bool(((p - start[n]).abs() <= bound).all()), n


def test_remat_keeps_loss_gradients_and_statistics(runs):
    """`camera_encoder.remat`: one step with the trunk's blocks checkpointed
    gives the loss, first moments and BatchNorm statistics of one without,
    and the recomputation leaves each running statistic updated once."""
    spec, variables, batch = runs["spec"], runs["variables"], runs["batches"][0]
    out = {}
    for remat in (False, True):
        s = dataclasses.replace(spec, camera=dataclasses.replace(spec.camera, remat=remat))
        model, opt, step = port_step_from(s, variables)
        trunk = model.camera_encoder.trunk
        assert trunk.remat == remat and any(isinstance(m, FlaxBatchNorm2d) for m in trunk.modules())
        out[remat] = (step(batch), first_moments(model, opt), model.state_dict())
    (l0, mu0, sd0), (l1, mu1, sd1) = out[False], out[True]
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in mu0:
        torch.testing.assert_close(mu1[k], mu0[k], rtol=1e-6, atol=0, msg=k)
    for k in sd0:
        torch.testing.assert_close(sd1[k], sd0[k], rtol=1e-6, atol=0, msg=k)
    counts = [k for k in sd1 if ".trunk." in k and k.endswith("num_batches_tracked")]
    assert counts and all(int(sd1[k]) == 1 for k in counts)
