"""The port's checkpoints against the JAX package's: the msgpack codec
against flax's, checkpoints written by each package restored by the other
(parameters, BatchNorm statistics, AdamW moments and counts equal; the f32
forward and the next optimizer update agree), the optimizer-state trees of
the four optimizer cases (Q6 constant lr and warmup + cosine, each with and
without gradient accumulation), strict=False restores, `latest_checkpoint`
and a bit-exact resume.

The JAX side's moments come from `tx.update` with seeded gradients (not a
jitted train step, whose compile would dominate the run); the port side's
from real train steps."""

import dataclasses
import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.train import checkpoint as jax_ckpt
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import Trainer as JaxTrainer
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import make_optimizer as jax_make_optimizer
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import TrainState
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import checkpoint as port_ckpt
from bevfusion_multimodal_3d_object_detection_tpu_torch.train.loop import Trainer
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import (
    export_jax_variables,
    load_jax_variables,
    opt_state_to_jax,
)
from torch_port_helpers import detector_inputs, narrow_spec, numpy_tree, random_variables, to_port_spec

# name: (compat.constant_lr, gradient accumulation steps)
CASES = {"q6-constant": (True, 1), "q6-constant-accum": (True, 2),
         "warmup-cosine": (False, 1), "warmup-cosine-accum": (False, 2)}
STEPS_PER_EPOCH = 2


def _train_specs(case):
    constant, accum = CASES[case]
    ts = jax_config.TrainSpec(batch_size=2, learning_rate=1e-3, warmup_epochs=1, warmup_initial_lr=1e-4,
                              lr_t_max=3, lr_eta_min=1e-5, grad_accum_steps=accum, grad_clip_norm=1.0)
    compat = jax_config.CompatFlags(constant_lr=constant)
    return ts, compat


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {prefix} if not tree else set()  # an empty state is a leaf of the layout
        for k, v in tree.items():
            out |= _leaf_paths(v, prefix + (k,))
        return out
    return {prefix}


def assert_trees_equal(got, want, what):
    """Same key sets in both directions, and every leaf equal bit for bit
    in dtype and shape."""
    assert _leaf_paths(got) == _leaf_paths(want), what
    for path in _leaf_paths(want):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        if isinstance(w, dict):
            assert g == {} and w == {}, (what, path)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, path, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), (what, path)


@pytest.fixture(scope="module")
def jax_case():
    """The narrow tri-modal detector: the JAX model, seeded variables with
    non-trivial BatchNorm statistics, and eval inputs."""
    spec = narrow_spec()
    model = JaxDetector(spec=spec)
    inputs = detector_inputs(spec, batch=1, seed=4)
    variables = jax.jit(functools.partial(model.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, inputs))
    return spec, model, random_variables(variables, seed=5), inputs


@functools.lru_cache(maxsize=None)
def _jax_update(case):
    """(tx, jitted (grads, opt_state, params) -> (params, opt_state)) of
    JAX's make_optimizer for `case`: one compile per case for both
    directions."""
    ts, compat = _train_specs(case)
    tx = jax_make_optimizer(ts, compat, STEPS_PER_EPOCH)

    def step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return tx, jax.jit(step)


def _grads(params, rng):
    return jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)


@functools.lru_cache(maxsize=None)
def _jitted_apply(model):
    return jax.jit(functools.partial(model.apply, train=False))


def _jax_forward(model, params, batch_stats, inputs):
    out = _jitted_apply(model)({"params": params, "batch_stats": batch_stats}, *map(jnp.asarray, inputs))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_forward(model, inputs):
    model.eval()
    with torch.no_grad():
        out = model(*(torch.from_numpy(x) for x in inputs))
    return {k: v.numpy() for k, v in out.items()}


def _assert_forward_close(got, want):
    """f32, the same weights: 1e-5 of each output's largest magnitude."""
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(got[k] - w).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def _port_trainer(spec, case):
    ts, compat = _train_specs(case)
    model = MultiModal3DDetector(to_port_spec(spec))
    trainer = Trainer(model, to_port_spec(ts), to_port_spec(compat), steps_per_epoch=STEPS_PER_EPOCH,
                      device="cpu")
    return trainer.init_state()


def _next_update_matches(port_trainer, jax_state, case, seed):
    """One more update from the restored state with the same gradients in
    both packages: the count, the schedule, the bias correction and the
    accumulator all have to agree for the parameters to."""
    grads = _grads(jax_state.params, np.random.RandomState(seed))
    want = numpy_tree(_jax_update(case)[1](grads, jax_state.opt_state, jax_state.params)[0])
    # the gradients reach torch's layout through a model of their own
    shadow = load_jax_variables(MultiModal3DDetector(port_trainer.model.spec),
                                {"params": numpy_tree(grads), "batch_stats": numpy_tree(jax_state.batch_stats)})
    by_name = dict(shadow.named_parameters())
    names = {id(p): n for n, p in port_trainer.model.named_parameters()}
    with torch.no_grad():
        port_trainer.optimizer.update([by_name[names[id(p)]].detach().clone()
                                       for p in port_trainer.optimizer.params])
    got = export_jax_variables(port_trainer.model)["params"]
    assert _leaf_paths(got) == _leaf_paths(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_restores_into_port(case, jax_case, tmp_path):
    spec, model, variables, inputs = jax_case
    ts, compat = _train_specs(case)
    jtrainer = JaxTrainer(model, ts, compat, steps_per_epoch=STEPS_PER_EPOCH)
    tx, update = _jax_update(case)
    params, opt = variables["params"], tx.init(variables["params"])
    rng = np.random.RandomState(6)
    n = 3 if ts.grad_accum_steps > 1 else 2  # with accumulation: one update, one micro-step pending
    for _ in range(n):
        params, opt = update(_grads(params, rng), opt, params)
    jtrainer.state = TrainState(step=jnp.asarray(n, jnp.int32), params=params,
                                batch_stats=variables["batch_stats"], opt_state=opt)
    jtrainer.best_map = 0.25
    path = str(tmp_path / "jax.msgpack")
    jtrainer.save_checkpoint(path, epoch=3)

    trainer = _port_trainer(spec, case)
    assert trainer.load_checkpoint(path) == 3
    assert trainer.step == n and trainer.best_map == np.float32(0.25)
    assert_trees_equal(export_jax_variables(trainer.model),
                       {"params": numpy_tree(params), "batch_stats": numpy_tree(variables["batch_stats"])},
                       "variables")
    assert_trees_equal(opt_state_to_jax(trainer.optimizer, trainer.model),
                       fser.to_state_dict(jax.tree_util.tree_map(np.asarray, opt)), "opt_state")
    _assert_forward_close(_port_forward(trainer.model, inputs),
                          _jax_forward(model, params, variables["batch_stats"], inputs))
    _next_update_matches(trainer, jtrainer.state, case, seed=7)


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_restores_into_jax(case, jax_case, tmp_path):
    spec, model, variables, inputs = jax_case
    trainer = _port_trainer(spec, case)
    load_jax_variables(trainer.model, variables)  # non-trivial BatchNorm statistics
    rng = np.random.RandomState(8)
    h, w = spec.camera.image_size
    n = 3 if CASES[case][1] > 1 else 2
    for _ in range(n):
        boxes = np.zeros((2, 4, 7), np.float32)
        boxes[:, :2, :2] = rng.uniform(-40, 40, (2, 2, 2))
        boxes[:, :2, 3:6] = rng.uniform(1, 4, (2, 2, 3))
        labels = np.full((2, 4), -1, np.int64)
        labels[:, :2] = rng.randint(0, 10, (2, 2))
        trainer.train_step({
            "camera_imgs": rng.randint(0, 256, (2, 6, h, w, 3), np.uint8),
            "lidar_points": rng.randn(2, spec.lidar.max_points, 4).astype(np.float32) * 10,
            "radar_points": rng.randn(2, 5, spec.radar.max_points_per_sensor, 7).astype(np.float32),
            "gt_boxes": boxes, "gt_labels": labels,
        })
    trainer.best_map = 0.5
    path = str(tmp_path / "port.msgpack")
    trainer.save_checkpoint(path, epoch=2)

    ts, compat = _train_specs(case)
    jtrainer = JaxTrainer(model, ts, compat, steps_per_epoch=STEPS_PER_EPOCH)
    jtrainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                opt_state=jtrainer.tx.init(variables["params"]))
    # the file's key set is the JAX payload's, both ways: a misnamed key
    # would fail in JAX, a missing one would keep the template's value
    template = {"params": variables["params"], "batch_stats": variables["batch_stats"],
                "opt_state": jtrainer.state.opt_state, "step": jtrainer.state.step,
                "epoch": jnp.zeros((), jnp.int32), "best_map": jnp.zeros(())}
    raw = fser.msgpack_restore(open(path, "rb").read())
    assert _leaf_paths(raw) == _leaf_paths(fser.to_state_dict(jax.tree_util.tree_map(np.asarray, template)))
    assert jtrainer.load_checkpoint(path) == 2
    state = jtrainer.state
    assert int(state.step) == n and jtrainer.best_map == np.float32(0.5)
    assert_trees_equal({"params": numpy_tree(state.params), "batch_stats": numpy_tree(state.batch_stats)},
                       export_jax_variables(trainer.model), "variables")
    assert_trees_equal(fser.to_state_dict(jax.tree_util.tree_map(np.asarray, state.opt_state)),
                       opt_state_to_jax(trainer.optimizer, trainer.model), "opt_state")
    _assert_forward_close(_port_forward(trainer.model, inputs),
                          _jax_forward(model, state.params, state.batch_stats, inputs))
    _next_update_matches(trainer, state, case, seed=9)


@pytest.mark.parametrize("case", list(CASES))
def test_opt_state_tree_matches_jax(case, jax_case):
    """Fresh state: the port's optimizer maps onto the exact
    ``to_state_dict`` tree of JAX's tx (keys, dtypes, shapes, values)."""
    spec, model, variables, _ = jax_case
    ts, compat = _train_specs(case)
    tx = JaxTrainer(model, ts, compat, steps_per_epoch=STEPS_PER_EPOCH).tx
    trainer = _port_trainer(spec, case)
    load_jax_variables(trainer.model, variables)
    want = fser.to_state_dict(jax.tree_util.tree_map(np.asarray, tx.init(variables["params"])))
    assert_trees_equal(opt_state_to_jax(trainer.optimizer, trainer.model), want, case)


def _payload_tree():
    rng = np.random.RandomState(0)
    return {
        "params": {"conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                            "bias": np.zeros(4, np.float32)},
                   "dense": {"kernel": rng.randn(5, 2).astype(np.float64)}},
        "opt_state": {"0": {}, "1": {"0": {"count": np.asarray(7, np.int32),
                                           "mu": {"a": rng.randn(2).astype(np.float32)}},
                                     "1": {}, "2": {"count": np.asarray(3, np.int32)}}},
        "scalars": {"f32": np.float32(0.5), "i64": np.int64(-3), "u8": np.uint8(200),
                    "b": np.bool_(True), "f16": np.float16(1.5)},
        "arrays": {"bool": np.array([True, False]), "i8": np.arange(-3, 3, dtype=np.int8),
                   "u16": np.arange(4, dtype=np.uint16).reshape(2, 2), "empty": np.zeros((0, 3), np.float32),
                   "big_int": np.array([2 ** 40], np.int64)},
        "python": {"int": 5, "neg": -70000, "big": 2 ** 40, "float": 0.1, "str": "epoch",
                   "none": None, "true": True, "list": [1, 2.5, "x"]},
        "step": np.asarray(11, np.int32), "epoch": np.asarray(2, np.int32),
        "best_map": np.asarray(0.125, np.float32),
    }


def test_codec_is_byte_identical_to_flax():
    tree = _payload_tree()
    data = fser.msgpack_serialize(tree)
    assert port_ckpt.msgpack_serialize(tree) == data
    got = port_ckpt.msgpack_restore(data)
    want = fser.msgpack_restore(data)
    assert _leaf_paths(got) == _leaf_paths(want)
    for path in _leaf_paths(want):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert type(g) is type(w), path
        if isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and np.array_equal(g, w), path
        else:
            assert g == w, path


def test_strict_false_semantics(tmp_path):
    """As tests/test_train_and_parallel.py:282 for the JAX package: a
    camera-only checkpoint into a tri-modal model raises on the fusion
    conv's shape, and with keep_on_shape_mismatch keeps the encoders the
    file lacks while the camera trunk is restored."""
    spec = to_port_spec(narrow_spec())
    cam_spec = dataclasses.replace(spec, use_lidar=False, use_radar=False)
    ts = to_port_spec(jax_config.TrainSpec(batch_size=2))
    compat = to_port_spec(jax_config.CompatFlags())
    cam = Trainer(MultiModal3DDetector(cam_spec), ts, compat, device="cpu").init_state()
    path = str(tmp_path / "cam_only.msgpack")
    cam.save_checkpoint(path, epoch=0)

    tri = Trainer(MultiModal3DDetector(spec), dataclasses.replace(ts, seed=7), compat, device="cpu").init_state()
    before = tri.model.lidar_encoder.point_mlp.mlp1.weight.detach().clone()
    with pytest.raises(ValueError, match="shape mismatch"):
        tri.load_checkpoint(path)
    tri.load_checkpoint(path, keep_on_shape_mismatch=True)
    assert torch.equal(tri.model.lidar_encoder.point_mlp.mlp1.weight, before)
    assert torch.equal(tri.model.camera_encoder.trunk.conv1.weight, cam.model.camera_encoder.trunk.conv1.weight)
    # a dict where an array belongs (a restructured module) raises too
    with pytest.raises(ValueError, match="structure mismatch"):
        port_ckpt._tolerant_merge({"a": np.zeros(2)}, {"a": {"b": np.zeros(2)}})
    assert port_ckpt._tolerant_merge({"a": np.zeros(2)}, {"a": {"b": 1}}, keep_on_shape_mismatch=True)["a"].shape == (2,)


def test_latest_checkpoint_skips_staging_files(tmp_path):
    for name in ("checkpoint_epoch_1.msgpack", "checkpoint_epoch_2.msgpack", "checkpoint_epoch_9.msgpack.tmp",
                 "checkpoint_epoch_x.msgpack", "best_model.msgpack"):
        (tmp_path / name).write_bytes(b"")
    got = port_ckpt.latest_checkpoint(str(tmp_path))
    assert got == (str(tmp_path / "checkpoint_epoch_2.msgpack"), 2)
    assert got == jax_ckpt.latest_checkpoint(str(tmp_path))
    assert port_ckpt.latest_checkpoint(str(tmp_path / "absent")) == (None, -1)


def _train_batches(spec, n):
    rng = np.random.RandomState(10)
    h, w = spec.camera.image_size
    batches = []
    for _ in range(n):
        labels = np.full((2, 3), -1, np.int64)
        labels[:, 0] = rng.randint(0, 10, 2)
        boxes = np.zeros((2, 3, 7), np.float32)
        boxes[:, 0] = [5.0, -3.0, 0.0, 2.0, 4.0, 1.5, 0.3]
        batches.append({
            "camera_imgs": rng.randint(0, 256, (2, 6, h, w, 3), np.uint8),
            "lidar_points": rng.randn(2, spec.lidar.max_points, 4).astype(np.float32) * 10,
            "radar_points": rng.randn(2, 5, spec.radar.max_points_per_sensor, 7).astype(np.float32),
            "gt_boxes": boxes, "gt_labels": labels,
        })
    return batches


@pytest.mark.parametrize("case", ["q6-constant", "warmup-cosine-accum"])
def test_resume_is_bit_exact(case, tmp_path):
    """Steps 1..3 uninterrupted, and steps 1, 2 / save / restore into a new
    Trainer / step 3: the same parameters, statistics and optimizer state
    bit for bit (with accumulation the save falls between micro-steps)."""
    spec = narrow_spec()
    batches = _train_batches(spec, 3)
    straight = _port_trainer(spec, case)
    for b in batches:
        straight.train_step(b)
    first = _port_trainer(spec, case)
    for b in batches[:2]:
        first.train_step(b)
    path = str(tmp_path / "resume.msgpack")
    first.save_checkpoint(path, epoch=0)
    resumed = _port_trainer(dataclasses.replace(spec), case)
    with torch.no_grad():  # a different start, which the restore must overwrite
        for p in resumed.model.parameters():
            p.add_(1.0)
    resumed.load_checkpoint(path)
    resumed.train_step(batches[2])
    assert resumed.step == straight.step == 3
    assert_trees_equal(export_jax_variables(resumed.model), export_jax_variables(straight.model), "variables")
    assert_trees_equal(opt_state_to_jax(resumed.optimizer, resumed.model),
                       opt_state_to_jax(straight.optimizer, straight.model), "opt_state")


def _count_one_short(restore):
    def mutant(optimizer, model, state):
        restore(optimizer, model, state)
        optimizer.updates -= 1
        for s in optimizer.adamw.state.values():
            s["step"] -= 1
    return mutant


def _second_moments_from_the_first(restore):
    def mutant(optimizer, model, state):
        restore(optimizer, model, state)
        for s in optimizer.adamw.state.values():
            s["exp_avg_sq"] = s["exp_avg"].clone()
    return mutant


@pytest.mark.parametrize("mutant", [None, _count_one_short, _second_moments_from_the_first],
                         ids=["restore", "count-one-short", "second-moments-from-the-first"])
def test_resume_check_rejects_restore_mutants(mutant, tmp_path, monkeypatch):
    """chip_smoke.py's phase 11 holds the state just after a resume to the
    state saved (`trainer_state`, `assert_states_equal`): it passes a true
    restore and fails one that restores the update count one short or the
    second moments from the first."""
    from chip_smoke import assert_states_equal, trainer_state

    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils import convert

    spec = narrow_spec()
    first = _port_trainer(spec, "warmup-cosine")
    for b in _train_batches(spec, 2):
        first.train_step(b)
    saved = trainer_state(first)
    path = str(tmp_path / "resume.msgpack")
    first.save_checkpoint(path, epoch=0)
    if mutant is not None:
        monkeypatch.setattr(convert, "opt_state_from_jax", mutant(convert.opt_state_from_jax))
    resumed = _port_trainer(spec, "warmup-cosine")
    assert resumed.load_checkpoint(path) == 0
    if mutant is None:
        assert assert_states_equal(trainer_state(resumed), saved) > 0
    else:
        with pytest.raises(AssertionError, match="restored"):
            assert_states_equal(trainer_state(resumed), saved)
