"""The port's two-rank data-parallel step against the JAX package's Trainer
on a two-device ``'data'`` mesh (``make_mesh(n_data=2)``, jitted, on
conftest's virtual CPU devices), from the same variables (`utils.convert`),
on the batches of `torch_parallel_worker.parallel_batches`, whose halves
differ in positives and BatchNorm statistics.

Both run in float64, and JAX's mesh step is held to the port's one step
as test_torch_train.py holds a step to its float64 reference, at twice those
limits (`chip_smoke.step_errors`' ratios at most 2): losses 2e-5 relative,
grad_norm 2e-4, AdamW first moments 2e-4 of each tensor's largest
(zero-gradient tensors, the biases right before a BatchNorm, within 1e-5 of
the largest of all), parameters 2e-6 but near-zero-gradient elements 2 lr,
BatchNorm statistics 2e-5.

Why not JAX's f32 mesh step, on camera+radar: a jitted f32 JAX step lands
240-950 times the first-moment limit away from the float64 step in the
camera trunk on these batches at every weight seed tried (0-3, 5), one
device or two; and a jitted float64 step gets the point encoders' gradients
wrong on the CPU backend (port_numerics.py), so the model is camera-only.
One step: the losses are f32 in both packages, and the next step's
parameters then differ by up to 7e-6 of a tensor's largest between the
packages, single-process as on the mesh.

In the same two processes, laid out as (data 1, view 2), the port's
view-rank eval forward of a ``bev_spatial`` tri-modal model (each rank's 3
cameras through the trunk and 8 of the 16 BEV rows through the head) against
the JAX forward jitted on a ``make_mesh(n_data=1, n_view=2)`` mesh with the
cameras sharded over ``'view'`` and the fused map's rows pinned to it, from
the same variables, at 1e-5 of each output's largest, in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector as JaxDetector
from bevfusion_multimodal_3d_object_detection_tpu.parallel import make_mesh, shard_batch
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import Trainer as JaxTrainer
from bevfusion_multimodal_3d_object_detection_tpu.train.loop import TrainState
from bevfusion_multimodal_3d_object_detection_tpu_torch.models.detector import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from chip_smoke import step_errors
from torch_parallel_worker import launch, parallel_batches
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec
from torch_train_helpers import LR, adam_moments, port_layout

STEPS = 1


def jax_mesh_steps(spec, variables, batches):
    """JAX's Trainer step on a 2-device mesh over `batches`, jitted, in
    float64. One record a step (losses, variables, first moments; numpy)."""
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        trainer = JaxTrainer(JaxDetector(spec=spec, mask_padding=False, dtype=jnp.float64),
                             jax_config.TrainSpec(), jax_config.CompatFlags(), mesh=make_mesh(n_data=2),
                             check_gradients=True)
        params = f64(variables["params"])
        trainer.state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   batch_stats=f64(variables["batch_stats"]), opt_state=trainer.tx.init(params))
        records = []
        for batch in batches:
            batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}
            trainer.state, losses = trainer.train_step(trainer.state, trainer._device_batch(batch), trainer.rng)
            mu, _ = adam_moments(trainer.state.opt_state)
            state = jax.tree_util.tree_map(np.asarray, {"params": trainer.state.params,
                                                        "batch_stats": trainer.state.batch_stats})
            records.append({"losses": {k: float(v) for k, v in losses.items()}, "variables": state, "mu": mu})
    return records


def jax_view_forward(spec, variables, inputs):
    """The JAX eval forward, jitted, on a (data 1, view 2) mesh: the cameras
    sharded over 'view' (`shard_batch`), the fused map's rows pinned to it
    (the CLI's ``bev_sharding`` under ``bev_spatial``); numpy maps."""
    mesh = make_mesh(n_data=1, n_view=2)
    model = JaxDetector(spec=spec, mask_padding=False, bev_sharding=NamedSharding(mesh, P(None, "view")))
    batch = shard_batch(mesh, dict(zip(("camera_imgs", "lidar_points", "radar_points"), inputs)))
    assert batch["camera_imgs"].sharding.spec[1] == "view"
    out = jax.jit(lambda v, c, l, r: model.apply(v, c, l, r, train=False))(
        variables, batch["camera_imgs"], batch["lidar_points"], batch["radar_points"])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    spec = narrow_spec("camera")
    port_spec = to_port_spec(spec)
    batches = parallel_batches(port_spec, STEPS, seed=1)
    init = JaxDetector(spec=spec).init({"params": jax.random.PRNGKey(0)},
                                       *(jnp.asarray(batches[0][k][:1]) for k in ("camera_imgs", "lidar_points",
                                                                                   "radar_points")))
    variables = random_variables(init, seed=5)
    state = load_jax_variables(MultiModal3DDetector(port_spec).double(), variables).state_dict()
    # the view-parallel forward: tri-modal, f32
    tri = narrow_spec("camera+lidar+radar")
    port_tri = to_port_spec(tri)
    inputs = detector_inputs(port_tri, batch=2, seed=2)
    tri_vars = random_variables(JaxDetector(spec=tri).init({"params": jax.random.PRNGKey(1)},
                                                           *(a[:1] for a in inputs)), seed=6)
    tri_state = load_jax_variables(MultiModal3DDetector(port_tri), tri_vars).state_dict()
    ranks, (want, want_forward) = launch(
        [("train_steps", dict(spec=port_spec, state=state, batches=batches)),
         ("view_forward", dict(spec=port_tri, state=tri_state, inputs=inputs))],
        during=lambda: (jax_mesh_steps(spec, variables, batches), jax_view_forward(tri, tri_vars, inputs)))
    return {"spec": spec, "variables": variables, "ranks": ranks, "want": want, "want_forward": want_forward}


def test_two_ranks_equal_the_jax_mesh_step(runs):
    spec, want, bs = runs["spec"], runs["want"], runs["variables"]["batch_stats"]
    for rank in runs["ranks"]:
        records = rank[0]["records"]
        for step, record in enumerate(want):
            # JAX's f32 step held to the port's float64 step, as
            # test_torch_train.py holds an f32 step to a float64 reference
            got = port_layout(spec, record, bs)
            got["mu"] = {k: got["mu"][k] for k in records[step]["mu"]}  # the parameters' (no buffers)
            prev_mu = records[step - 1]["mu"] if step else None
            worst, failures = step_errors(got, records[step], prev_mu, LR, f"step {step + 1}", grad_norm_rtol=1e-4)
            assert all(v <= 2.0 for v in worst.values()), (worst, failures)
            assert not [f for f in failures if "of the limit" not in f], failures


def test_view_ranks_forward_equals_the_jax_mesh_forward(runs):
    want = runs["want_forward"]
    for rank in runs["ranks"]:
        got = rank[1]
        assert got["head_on_rows"]
        assert set(got["preds"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["preds"][k], w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
