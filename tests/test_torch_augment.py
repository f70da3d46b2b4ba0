"""The port's training augmentations (`ops.augment`) against the JAX
package's: each transform fed JAX's own draws (computed here with the same
``jax.random`` calls as ``ops/augment.py``), the port's draws, padding rows,
`geometry_frozen`, `AugmentSpec`, and the train step: augmentation equals
the plain step on the augmented batch, and a resumed Trainer draws what the
uninterrupted run drew.

f32 on the CPU; tolerance 1e-6 of each output's scale (the same products,
means summed in another order)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.ops import augment as jax_aug
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import augment as port_aug
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from torch_port_helpers import narrow_spec, to_port_spec
from torch_train_helpers import make_batches
from torch_trainer_helpers import ROOT

TOL = 1e-6
AUG = jax_config.AugmentSpec()


def _jax_draws(key, b, radar_shape, aug=AUG):
    """The draws JAX's `augment_modalities(key, ...)` makes, as an
    `AugmentDraws` (augment.py:160, :41-50, :75-77, :133-136)."""
    kc, kl, kr = jax.random.split(key, 3)
    kb, kcc, ks = jax.random.split(kc, 3)
    shape = (b, 1, 1, 1, 1)
    jitter = [jax.random.uniform(k, shape, minval=1 - x, maxval=1 + x).reshape(b)
              for k, x in ((kb, aug.brightness), (kcc, aug.contrast), (ks, aug.saturation))]
    kf, kss = jax.random.split(kl)
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    scale = jax.random.uniform(kss, (b,), minval=aug.scale_min, maxval=aug.scale_max)
    normal = jax.random.normal(kr, radar_shape, jnp.float32)
    t = lambda a: torch.from_numpy(np.array(a))
    return port_aug.AugmentDraws(t(jnp.stack(jitter)), t(flip), t(scale), t(normal))


def _scene(seed=0, b=4, n_cols=9):
    """Cameras (B, 6, H, W, 3), LiDAR (B, 32, 5) and radar (B, 5, 8, 7) with
    zero-padded rows, boxes (B, 6, n_cols)."""
    rng = np.random.RandomState(seed)
    cams = rng.randn(b, 6, 4, 8, 3).astype(np.float32)
    lidar = (rng.randn(b, 32, 5) * 20).astype(np.float32)
    lidar[:, 20:] = 0.0
    radar = (rng.randn(b, 5, 8, 7) * 10).astype(np.float32)
    radar[:, :, 5:] = 0.0
    boxes = (rng.randn(b, 6, n_cols) * 10).astype(np.float32)
    return cams, lidar, radar, boxes


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("geometry_frozen", [False, True], ids=["scene", "geometry-frozen"])
@pytest.mark.parametrize("n_cols", [7, 9])
def test_augment_modalities_matches_jax(n_cols, geometry_frozen):
    """Every transform through the dispatch, on JAX's draws; frozen
    geometry leaves LiDAR and boxes as they are."""
    cams, lidar, radar, boxes = _scene(1, n_cols=n_cols)
    key = jax.random.PRNGKey(7)
    want = jax_aug.augment_modalities(key, *map(jnp.asarray, (cams, lidar, radar, boxes)), AUG,
                                      geometry_frozen=geometry_frozen)
    draws = _jax_draws(key, 4, radar.shape)
    assert draws.flip.any() and not draws.flip.all()
    got = port_aug.augment_modalities(draws, *map(torch.from_numpy, (cams, lidar, radar, boxes)),
                                      to_port_spec(AUG), geometry_frozen=geometry_frozen)
    for g, w in zip(got, want):
        _close(g, w)
    if geometry_frozen:
        assert torch.equal(got[1], torch.from_numpy(lidar)) and torch.equal(got[3], torch.from_numpy(boxes))


@pytest.mark.parametrize("transform", ["color_jitter", "flip_scale_scene", "lidar_flip_scale", "radar_noise"])
def test_transform_matches_jax(transform):
    cams, lidar, radar, boxes = _scene(2)
    key = jax.random.PRNGKey(3)
    t = torch.from_numpy
    if transform == "color_jitter":
        want = [jax_aug.color_jitter(key, jnp.asarray(cams), 0.3, 0.1, 0.4)]
        kb, kc, ks = jax.random.split(key, 3)
        f = [jax.random.uniform(k, (4, 1, 1, 1, 1), minval=1 - x, maxval=1 + x).reshape(4)
             for k, x in ((kb, 0.3), (kc, 0.1), (ks, 0.4))]
        got = [port_aug.color_jitter(t(cams), t(np.stack(f)))]
    elif transform == "radar_noise":
        want = [jax_aug.radar_noise(key, jnp.asarray(radar), 0.05)]
        got = [port_aug.radar_noise(t(radar), t(np.array(jax.random.normal(key, radar.shape))), 0.05)]
    else:
        kf, ks = jax.random.split(key)
        flip = t(np.array(jax.random.bernoulli(kf, 0.5, (4,))))
        scale = t(np.array(jax.random.uniform(ks, (4,), minval=0.9, maxval=1.1)))
        if transform == "flip_scale_scene":
            want = jax_aug.flip_scale_scene(key, *map(jnp.asarray, (lidar, boxes, radar)), scale_min=0.9,
                                            scale_max=1.1)
            got = port_aug.flip_scale_scene(t(lidar), t(boxes), t(radar), flip, scale)
        else:
            want = jax_aug.lidar_flip_scale(key, jnp.asarray(lidar), jnp.asarray(boxes), 0.9, 1.1)
            got = port_aug.lidar_flip_scale(t(lidar), t(boxes), flip, scale)
    for g, w in zip(got, want):
        _close(g, w)


def test_padding_rows_stay_zero():
    """Flip, scale and noise leave zero-padded rows zero (the validity mask
    keys off them); real radar rows get noise of about noise_std."""
    cams, lidar, radar, boxes = _scene(3)
    g = torch.Generator().manual_seed(0)
    draws = port_aug.draw_augmentation(g, to_port_spec(AUG), 4, radar.shape)
    _, l2, r2, _ = port_aug.augment_modalities(draws, None, torch.from_numpy(lidar), torch.from_numpy(radar),
                                               torch.from_numpy(boxes), to_port_spec(AUG))
    assert (l2[:, 20:] == 0).all() and (r2[:, :, 5:] == 0).all()
    assert (l2[:, :20] != 0).all()
    noisy = port_aug.radar_noise(torch.from_numpy(radar), draws.radar_noise, 0.01)
    assert (noisy[:, :, 5:] == 0).all()
    assert 0.008 < float((noisy - torch.from_numpy(radar))[:, :, :5].std()) < 0.012


def test_port_draws():
    """Ranges and flip rate of the port's draws, their fixed order, and
    `step_generator`'s dependence on (seed, step) alone."""
    aug = to_port_spec(AUG)
    d = port_aug.draw_augmentation(port_aug.step_generator(4, 9), aug, 4000, (2, 3))
    for f, x in zip(d.jitter, (aug.brightness, aug.contrast, aug.saturation)):
        assert 1 - x <= float(f.min()) < 1 - 0.9 * x and 1 + 0.9 * x < float(f.max()) <= 1 + x
    assert aug.scale_min <= float(d.scale.min()) and float(d.scale.max()) <= aug.scale_max
    assert 0.46 < float(d.flip.float().mean()) < 0.54
    assert d.radar_noise.shape == (2, 3) and d.jitter.dtype == d.scale.dtype == torch.float32
    again = port_aug.draw_augmentation(port_aug.step_generator(4, 9), aug, 4000, (2, 3))
    other = port_aug.draw_augmentation(port_aug.step_generator(4, 10), aug, 4000, (2, 3))
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    assert not torch.equal(d.scale, other.scale)


def test_augment_batch_keys():
    batch = {"camera_imgs": torch.zeros(2, 6, 4, 4, 3), "lidar_points": torch.ones(2, 16, 4),
             "radar_points": torch.zeros(2, 5, 8, 7), "gt_boxes": torch.ones(2, 4, 7),
             "gt_labels": torch.zeros(2, 4, dtype=torch.int32)}
    out = port_aug.augment_batch(torch.Generator().manual_seed(1), batch)
    assert set(out) == set(batch) and torch.equal(out["gt_labels"], batch["gt_labels"])
    assert torch.equal(out["radar_points"], batch["radar_points"])  # all padding: no noise
    assert not torch.equal(out["gt_boxes"], batch["gt_boxes"])


def test_augment_spec_matches_jax():
    cfg = port_config.load_config(str(ROOT / "configs" / "base.yaml"))
    cfg = copy.deepcopy(cfg)
    cfg["dataset"]["augmentation"]["lidar"]["random_scale"] = [0.9, 1.2]
    cfg["dataset"]["augmentation"]["radar"]["noise_std"] = 0.05
    want = jax_config.AugmentSpec.from_config(cfg)
    assert dataclasses.asdict(port_config.AugmentSpec.from_config(cfg)) == dataclasses.asdict(want)
    assert port_config.AugmentSpec.from_config(None) == port_config.AugmentSpec()


def _aug_step(spec, seed=0, skip=False, augment=None):
    model = port_det.MultiModal3DDetector(spec).init_weights(torch.Generator().manual_seed(seed))
    train, compat = port_config.TrainSpec(seed=5), port_config.CompatFlags(skip_augmentation=skip)
    return model, port_loop.make_train_step(model, port_loop.make_optimizer(train, compat), train, compat,
                                            augment=augment, device="cpu")


@pytest.mark.parametrize("mode", ["pseudo", "geometric"])
def test_augmented_step_is_the_plain_step_on_the_augmented_batch(mode):
    """The step with augmentation equals the step without it on the batch
    that `augment_modalities` returned; geometric freezes the flip."""
    spec = narrow_spec(bev=10, camera_to_bev="geometric", depth_bins=4) if mode == "geometric" else narrow_spec()
    spec = to_port_spec(spec)
    batch = make_batches(spec, n_cols=9)[0]
    model_a, step_a = _aug_step(spec, augment=port_config.AugmentSpec(noise_std=0.05))
    model_b, step_b = _aug_step(spec, skip=True)
    assert step_a.geometry_frozen == (mode == "geometric") and step_b.augment is None
    # the step's parts take the batch as its call moves it: on the device
    augmented = step_a.augmented({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()})
    if mode == "geometric":
        assert torch.equal(augmented["lidar_points"], torch.from_numpy(batch["lidar_points"]))
    else:
        assert not torch.equal(augmented["gt_boxes"], torch.from_numpy(batch["gt_boxes"]))
    assert augmented["camera_imgs"].dtype == torch.float32
    losses_a, losses_b = step_a(batch), step_b(augmented)
    assert losses_a.keys() == losses_b.keys()
    for k in losses_a:
        assert torch.equal(losses_a[k], losses_b[k]), k
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k


def test_resumed_trainer_repeats_the_draws(tmp_path, monkeypatch):
    """Two epochs in one run, and one epoch, a checkpoint and a restored
    second epoch: the same draws at every step and the same final state."""
    spec = to_port_spec(narrow_spec("camera+radar"))
    batches = make_batches(spec)
    train, compat = port_config.TrainSpec(seed=5), port_config.CompatFlags(skip_augmentation=False)
    draws = []
    real = port_loop.draw_augmentation
    monkeypatch.setattr(port_loop, "draw_augmentation", lambda *a, **k: draws.append(real(*a, **k)) or draws[-1])

    def trainer():
        t = port_loop.Trainer(port_det.MultiModal3DDetector(spec), train, compat, device="cpu")
        return t.init_state()

    whole = trainer()
    for _ in range(2):
        whole.train_one_epoch(batches, log_every=0)
    first, draws[:] = list(draws), []
    part = trainer()
    part.train_one_epoch(batches, log_every=0)
    part.save_checkpoint(str(tmp_path / "ckpt.msgpack"), 0)
    resumed = trainer()
    resumed.load_checkpoint(str(tmp_path / "ckpt.msgpack"))
    resumed.train_one_epoch(batches, log_every=0)
    assert len(first) == len(draws) == 4 and resumed.step == whole.step == 4
    for a, b in zip(first, draws):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(first[0].scale, first[1].scale)
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        # torch's BatchNorm call counter is no part of the JAX state a checkpoint holds
        assert k.endswith("num_batches_tracked") or torch.equal(a, b), k
