"""The port's optimizer and BatchNorm statistics against optax and flax.

- `lr_schedule` against the learning rate JAX's `make_optimizer` applies
  (constant under Q6, cosine, linear warmup + cosine) over three epochs of
  updates: read from an update of a unit parameter under zero gradient,
  where AdamW's step is -lr * weight_decay. optax evaluates a schedule in
  f32 (a few ulps of the larger rate it mixes): within 1e-7 of the peak
  rate.
- `clip_by_global_norm` against ``optax.clip_by_global_norm``, below and
  above the norm: 1e-12 in float64.
- `Optimizer` (clip + AdamW + schedule, and ``MultiSteps`` when
  accumulating) against JAX's `make_optimizer` fed the same float64
  gradient trees: parameters and moments after every (micro-)step, 1e-12 of
  each tensor's largest for the first moments, 1e-10 for the parameters
  (each step moves them by at most ~lr = 1e-4, at optax's f32 rate).
- ROADMAP C1: the running variance after one train-mode forward equals
  flax's ``batch_stats`` (biased variance, momentum 0.9), for the port's 2-D
  BatchNorm (`models.resnet.batch_norm`) and the point MLP's 1-D one; torch's
  own BatchNorm takes the unbiased variance and does not.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.train import loop as jax_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.encoders import _PointMLP
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.resnet import batch_norm
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop

SHAPES = ((3, 4), (5,), (2, 3, 2))


def _specs(**kw):
    jax_spec = dataclasses.replace(jax_config.TrainSpec(), **kw)
    return jax_spec, port_config.TrainSpec(**dataclasses.asdict(jax_spec))


SCHEDULES = {
    "constant_q6": (dict(), jax_config.CompatFlags()),
    "cosine": (dict(lr_t_max=2, lr_eta_min=1e-6), jax_config.CompatFlags(constant_lr=False)),
    "warmup_cosine": (dict(lr_t_max=2, lr_eta_min=1e-6, warmup_epochs=1, warmup_initial_lr=1e-5),
                      jax_config.CompatFlags(constant_lr=False)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    kw, compat = SCHEDULES[name]
    jax_spec, port_spec = _specs(**kw)
    steps_per_epoch = 4
    lr_at = port_loop.lr_schedule(port_spec, compat, steps_per_epoch)
    with jax.enable_x64(True):
        tx = jax_loop.make_optimizer(jax_spec, compat, steps_per_epoch)
        params = {"w": jnp.ones((1,), jnp.float64)}
        state = tx.init(params)
        for count in range(3 * steps_per_epoch):
            updates, state = tx.update({"w": jnp.zeros((1,), jnp.float64)}, state, params)
            want = -float(updates["w"][0]) / jax_spec.weight_decay
            assert abs(lr_at(count) - want) <= 1e-7 * jax_spec.learning_rate, count
    if name != "constant_q6":
        assert lr_at(0) != lr_at(3 * steps_per_epoch - 1)


@pytest.mark.parametrize("scale", [1e-3, 1e3], ids=["below", "above"])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(0)
    grads = [rng.randn(*s) * scale for s in SHAPES]
    max_norm = 10.0
    with jax.enable_x64(True):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = port_loop.clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
    norm = float(port_loop.global_norm([torch.from_numpy(g) for g in grads]))
    assert (norm < max_norm) == (scale < 1)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
        if scale < 1:
            assert np.array_equal(g.numpy(), orig)


@pytest.mark.parametrize("accum", [1, 2], ids=["every_step", "multisteps2"])
def test_optimizer_matches_optax(accum):
    """Six micro-steps of random gradients (large enough that the clip acts
    on some updates), warmup + cosine schedule."""
    jax_spec, port_spec = _specs(grad_accum_steps=accum, lr_t_max=2, warmup_epochs=1)
    compat = jax_config.CompatFlags(constant_lr=False)
    rng = np.random.RandomState(1)
    init = [rng.randn(*s) for s in SHAPES]
    params = [torch.tensor(p, requires_grad=True) for p in init]
    opt = port_loop.make_optimizer(port_spec, compat, steps_per_epoch=2).init(params)
    with jax.enable_x64(True):
        tx = jax_loop.make_optimizer(jax_spec, compat, steps_per_epoch=2)
        jparams = [jnp.asarray(p) for p in init]
        state = tx.init(jparams)
        for i in range(6):
            grads = [rng.randn(*s) * (20.0 if i % 3 == 0 else 0.5) for s in SHAPES]
            updates, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            before = [p.detach().clone() for p in params]
            moved = opt.update([torch.from_numpy(g) for g in grads])
            assert moved == ((i + 1) % accum == 0)
            assert opt.updates == (i + 1) // accum
            for p, w, b in zip(params, jparams, before):
                w = np.asarray(w)
                np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-10)
                if not moved:
                    assert torch.equal(p.detach(), b)
    inner = state.inner_opt_state if accum > 1 else state
    mu = inner[1][0].mu
    for p, m in zip(params, mu):
        m = np.asarray(m)
        np.testing.assert_allclose(opt.adamw.state[p]["exp_avg"].numpy(), m, rtol=0,
                                   atol=1e-12 * np.abs(m).max())


def _flax_stats(x_nhwc):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x_nhwc)
    _, mutated = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    return {k: np.asarray(v) for k, v in mutated["batch_stats"].items()}


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_batch_norm_running_stats_match_flax(kind):
    """ROADMAP C1: 4 rows x 3 channels (2-D: 4 x 3 x 2 x 2), from var 1."""
    rng = np.random.RandomState(0)
    if kind == "2d":
        x = rng.randn(4, 3, 2, 2).astype(np.float32) * 2 + 1
        port = batch_norm(3).train()
        flax_x = np.transpose(x, (0, 2, 3, 1))
    else:
        x = rng.randn(4, 3).astype(np.float32) * 2 + 1
        port = _PointMLP(3, (3,)).bn1.train()
        flax_x = x
    want = _flax_stats(jnp.asarray(flax_x))
    with torch.no_grad():
        port(torch.from_numpy(x))
    np.testing.assert_allclose(port.running_mean.numpy(), want["mean"], rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), want["var"], rtol=1e-6)
    # torch's own BatchNorm updates with the unbiased variance: n / (n - 1) off
    plain = (torch.nn.BatchNorm2d if kind == "2d" else torch.nn.BatchNorm1d)(3, momentum=0.1).train()
    with torch.no_grad():
        plain(torch.from_numpy(x))
    assert not np.allclose(plain.running_var.numpy(), want["var"], rtol=1e-3)


def test_batch_norm_refuses_cumulative_average():
    """flax's BatchNorm has no cumulative average (torch's momentum=None)."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.batch_norm import (
        FlaxBatchNorm1d,
        FlaxBatchNorm2d,
    )

    for cls in (FlaxBatchNorm1d, FlaxBatchNorm2d):
        with pytest.raises(ValueError, match="momentum"):
            cls(3, momentum=None)


def test_train_step_device_and_unported_options():
    """No fallback hides the device: without a GPU the train step raises
    unless the caller names the CPU. Augmentation (Q14 off) and freeze_bn,
    ported since, build: the step augments, the camera BNs stay in eval."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
    from torch_port_helpers import narrow_spec, to_port_spec

    spec = to_port_spec(narrow_spec())
    train, compat = port_config.TrainSpec(), port_config.CompatFlags()
    model = MultiModal3DDetector(spec)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_loop.make_train_step(model, port_loop.make_optimizer(train, compat), train, compat)
    augment = port_config.CompatFlags(skip_augmentation=False)
    step = port_loop.make_train_step(model, port_loop.make_optimizer(train, augment), train, augment, device="cpu")
    assert step.augment == port_config.AugmentSpec()
    frozen = MultiModal3DDetector(dataclasses.replace(
        spec, camera=dataclasses.replace(spec.camera, freeze_bn=True)))
    port_loop.make_train_step(frozen, port_loop.make_optimizer(train, compat), train, compat, device="cpu")
    assert frozen.training and not frozen.camera_encoder.channel_proj_bn.training
