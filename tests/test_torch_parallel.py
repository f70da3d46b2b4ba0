"""The port's data-parallel train step against one process at the global
batch: two gloo processes at 2 rows each and one process at 4 rows, from the
same state, on batches whose halves differ in positives and BatchNorm
statistics (`torch_parallel_worker.parallel_batches`), in float64 so that
the limits can be tight. Each step's losses within 1e-6 relative; the
parameters, BatchNorm running statistics and AdamW first moments within
1e-6 of each tensor's largest. The check rejects a step with per-rank
BatchNorm statistics and one with per-rank focal-loss positives. ZeRO-1 at
two ranks: half the moment bytes, the same parameters as plain data
parallelism, and a checkpoint of the full moments that the port (sharded
again) and the JAX package restore."""

import jax.numpy as jnp
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import CompatFlags as JaxCompat
from bevfusion_multimodal_3d_object_detection_tpu.config import TrainSpec as JaxTrainSpec
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import Trainer as JaxTrainer
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from chip_smoke import randomize_stats
from torch_parallel_worker import launch, parallel_batches, relative_errors, tensor_error, train_steps
from torch_port_helpers import narrow_spec, to_port_spec
from torch_train_helpers import adam_moments, state_dict_of

LIMIT = 1e-6
STEPS = 3


def within(got: dict, want: dict, limit: float = LIMIT) -> bool:
    return all(v <= limit for v in relative_errors(got, want).values())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    spec = to_port_spec(narrow_spec("camera+radar"))
    g = torch.Generator().manual_seed(3)
    state = randomize_stats(MultiModal3DDetector(spec).init_weights(g), g).double().state_dict()
    batches = parallel_batches(spec, STEPS)
    ckpt = str(tmp_path_factory.mktemp("zero") / "zero.msgpack")
    kw = dict(spec=spec, state=state)
    jobs = [
        ("train_steps", dict(kw, batches=batches)),
        ("train_steps", dict(kw, batches=batches[:1], mutant="bn")),
        ("train_steps", dict(kw, batches=batches[:1], mutant="num_pos")),
        ("train_steps", dict(kw, batches=batches[:2], skip_augmentation=False)),
        ("train_steps", dict(kw, batches=batches, shard_optimizer=True, checkpoint=ckpt)),
    ]
    ranks, (ref, ref_aug) = launch(jobs, during=lambda: (
        train_steps(spec, state, batches), train_steps(spec, state, batches[:2], skip_augmentation=False)))
    names = ("dp", "bn", "num_pos", "augment", "zero")
    return {"spec": spec, "state": state, "ckpt": ckpt, "ref": ref, "ref_augment": ref_aug,
            "ranks": [dict(zip(names, r)) for r in ranks]}


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_equal_one_rank_at_the_global_batch(runs, step):
    want = runs["ref"]["records"][step]
    for rank in runs["ranks"]:
        got = rank["dp"]["records"][step]
        errs = relative_errors(got, want)
        assert all(v <= LIMIT for v in errs.values()), errs
        assert set(got["losses"]) == set(want["losses"])  # the global losses, grad_norm included


@pytest.mark.parametrize("mutant", ["bn", "num_pos"])
def test_per_rank_statistics_and_normalizers_fail(runs, mutant):
    """A step whose BatchNorm statistics, or whose focal loss's positives,
    are each rank's alone is outside the limits."""
    want = runs["ref"]["records"][0]
    assert within(runs["ranks"][0]["dp"]["records"][0], want)
    errs = relative_errors(runs["ranks"][0][mutant]["records"][0], want)
    assert max(errs.values()) > 100 * LIMIT, errs


def test_augmentation_draws_for_the_global_batch(runs):
    """With augmentation on, each rank draws for the four rows and takes its
    own: both steps equal the one-process augmented steps."""
    for step, want in enumerate(runs["ref_augment"]["records"]):
        got = runs["ranks"][1]["augment"]["records"][step]
        assert within(got, want), relative_errors(got, want)
        assert not within(got, runs["ref"]["records"][step])  # the draws moved the batch


def test_zero_halves_the_moments_and_keeps_the_parameters(runs):
    full = runs["ranks"][0]["dp"]["moment_bytes"]
    for rank in runs["ranks"]:
        zero = rank["zero"]
        assert full / 2 <= zero["moment_bytes"] <= full / 2 + 16  # one shard padded by < world elements
        for step in range(STEPS):
            got, want = zero["records"][step], rank["dp"]["records"][step]
            assert within(got, want), relative_errors(got, want)
    a, b = (r["zero"]["records"][-1]["state"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)  # every rank ends with the same parameters


def test_zero_checkpoint_restores_in_both_packages(runs):
    """Rank 0 wrote the gathered moments in the JAX layout: the port
    restores and shards them again on both ranks, and the JAX Trainer
    restores the same values."""
    want = runs["ref"]["records"][-1]
    for rank in runs["ranks"]:
        restored = rank["zero"]["restored"]
        assert rank["zero"]["restored_updates"] == STEPS
        assert all(torch.equal(restored["mu"][k], rank["zero"]["records"][-1]["mu"][k]) for k in restored["mu"])
        # (torch's num_batches_tracked has no place in the JAX payload)
        assert all(torch.equal(restored["state"][k], rank["zero"]["records"][-1]["state"][k])
                   for k in restored["state"] if not k.endswith("num_batches_tracked"))
    spec = narrow_spec("camera+radar")
    trainer = JaxTrainer(JaxDetector(spec=spec), JaxTrainSpec(), JaxCompat())
    batch = {k: v[:1] for k, v in parallel_batches(to_port_spec(spec), 1)[0].items()}
    trainer.init_state({k: jnp.asarray(v) for k, v in batch.items()})
    trainer.load_checkpoint(runs["ckpt"])
    mu, _ = adam_moments(trainer.state.opt_state)
    got_mu = state_dict_of(spec, mu, trainer.state.batch_stats)
    assert int(trainer.state.step) == STEPS
    assert tensor_error(got_mu, want["mu"], 1e-9) <= LIMIT
