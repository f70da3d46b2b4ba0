"""Shared set-up of the train-step parity tests (tests/test_torch_train*.py):
batches with boxes, JAX's `make_train_step` run in f32 (jitted) or exactly
(float64, un-jitted), the port's step started from a JAX state, and the
comparison of one step against the exact reference.

The reference is exact so that the port's f32 step is held to a fixed
limit. It runs un-jitted: a jitted float64 JAX program gets the radar
encoder's gradient wrong on the CPU backend (up to 71 % of a kernel's
largest; a central finite difference agrees with the un-jitted gradient and
torch's, not the jitted one: port_numerics.py).

f32 gradients have no single value at a kink: a ReLU input or a max-pool
window that f32 rounding puts on the other side of it than float64. At the
variables' seed 3, the port's f32 step takes the other input of one window
of the trunk's max-pool (its two inputs 3.1e-8 of the tensor's
largest apart) and, downstream, the other side of two ReLU inputs; its
first moments are then off by up to 42 % of a tensor's largest
(``fusion.camera_proj2_bn.bias``; JAX's f32 step is off by 0.85 %, in the
trunk). With the float64 step's sides replayed into the f32 step, the
port's f32 first moments are within 1.6e-5 of a tensor's largest of the
float64 ones (port_numerics.py). So `check_step` holds an
f32 step to the reference where it crossed no tie, and else to the port's
float64 step on the f32 step's sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bevfusion_multimodal_3d_object_detection_tpu import config as jax_config
from bevfusion_multimodal_3d_object_detection_tpu.models import detector as jax_det
from bevfusion_multimodal_3d_object_detection_tpu.train import loop as jax_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch import config as port_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.data.dataset import chunk_plans
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import detector as port_det
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_pool, pointnet_fused
from bevfusion_multimodal_3d_object_detection_tpu_torch.train import loop as port_loop
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from chip_smoke import TieSides, ring_camera_cells
from torch_port_helpers import detector_inputs, narrow_spec, random_variables, to_port_spec

KEY = jax.random.PRNGKey(0)
COMPAT = jax_config.CompatFlags()
TRAIN = jax_config.TrainSpec()
LR = TRAIN.learning_rate
LOSS_KEYS = ("total_loss", "heatmap_loss", "offset_loss", "size_loss", "rot_loss", "vel_loss")


def train_spec_of(mode):
    if mode == "geometric":
        # splat_mode pallas with plans in the batch: training takes the matmul
        return narrow_spec(bev=10, camera_to_bev="geometric", depth_bins=4, splat_mode="pallas")
    return narrow_spec()


def make_batches(spec, n_cols=9, uint8=True):
    """Two collated batches of 2 samples: cameras (uint8 or float), points,
    M = 8 box rows of which 3 and 4 are real, labels -1 on padded rows;
    geometric specs get ring-calibration cells and chunk plans."""
    out = []
    for seed in (0, 1):
        cams, lidar, radar = detector_inputs(spec, batch=2, seed=seed)
        rng = np.random.RandomState(100 + seed)
        boxes = np.zeros((2, 8, n_cols), np.float32)
        labels = np.full((2, 8), -1, np.int64)
        for b in range(2):
            n = 3 + b
            boxes[b, :n, 0:2] = rng.uniform(-45, 45, (n, 2))
            boxes[b, :n, 2] = rng.uniform(-2, 1, n)
            boxes[b, :n, 3:6] = rng.uniform(1, 6, (n, 3))
            boxes[b, :n, 6] = rng.uniform(-3, 3, n)
            boxes[b, :n, 7:] = rng.randn(n, n_cols - 7)
            labels[b, :n] = rng.randint(0, 10, n)
        if uint8:
            cams = rng.randint(0, 256, cams.shape).astype(np.uint8)
        batch = {"camera_imgs": cams, "lidar_points": lidar, "radar_points": radar,
                 "gt_boxes": boxes, "gt_labels": labels}
        if spec.use_camera and spec.bev.camera_to_bev == "geometric":
            b = spec.bev
            cells = ring_camera_cells(spec.camera.image_size, (b.bev_h, b.bev_w), b.depth_bins,
                                      b.depth_min, b.depth_max, b.pc_range)
            plans = chunk_plans(cells, b.bev_h * b.bev_w)
            batch["camera_cells"] = np.stack([cells] * 2)
            batch.update({f"camera_{k}": np.stack([v] * 2) for k, v in plans.items()})
        out.append(batch)
    return out


def make_variables(spec, batch, seed=13):
    kw = {"camera_cells": jnp.asarray(batch["camera_cells"][:1])} if "camera_cells" in batch else {}
    args = [jnp.asarray(a[:1]) for a in detector_inputs(spec)]
    init = jax_det.MultiModal3DDetector(spec=spec).init({"params": KEY}, *args, **kw)
    return random_variables(init, seed)


def adam_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState in `make_optimizer`'s state
    (``chain(clip, adamw)``, inside ``MultiSteps`` when accumulating), as
    numpy (float64 stays float64)."""
    inner = getattr(opt_state, "inner_opt_state", opt_state)
    adam = inner[1][0]
    return _numpy(adam.mu), _numpy(adam.nu)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float64 if a.dtype == jnp.float64 else np.float32), tree)


def jax_steps(spec, variables, batches, train_spec=TRAIN, dtype=jnp.float32, exact=False):
    """JAX's make_train_step over `batches`; `exact` runs it in float64,
    un-jitted. One record per step: the loss dict, the new variables and the
    AdamW moments, as numpy."""
    model = jax_det.MultiModal3DDetector(spec=spec, mask_padding=not COMPAT.unmasked_point_padding,
                                         dtype=jnp.float64 if exact else dtype)
    tx = jax_loop.make_optimizer(train_spec, COMPAT)
    step = jax_loop.make_train_step(model, tx, train_spec, COMPAT, check_gradients=True)
    fdt = jnp.float64 if exact else jnp.float32

    def run():
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, fdt), t)
        params = cast(variables["params"])
        state = jax_loop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    batch_stats=cast(variables["batch_stats"]), opt_state=tx.init(params))
        records = []
        for batch in batches:
            jb = {k: jnp.asarray(v, fdt) if v.dtype == np.float32 else jnp.asarray(v)
                  for k, v in batch.items()}
            # the state is donated: read it out before the next call
            state, losses = step(state, jb, KEY)
            mu, nu = adam_moments(state.opt_state)
            records.append({
                "losses": {k: float(v) for k, v in losses.items()},
                "variables": _numpy({"params": state.params, "batch_stats": state.batch_stats}),
                "mu": mu, "nu": nu,
            })
        return records

    if exact:
        with jax.enable_x64(True), jax.disable_jit():
            return run()
    return run()


# Parameters whose gradient is zero by construction beyond the biases
# right before a BatchNorm: an attention key's bias adds the same value to
# all of a query's scores, which the softmax does not see. JAX's float64
# reference computes the scores in f32 (`preferred_element_type`), so its
# gradient there is rounding noise (below 1e-5 of the largest) and not 0.
ZERO_GRADIENT = (".key.bias",)


def loss_keys(losses):
    """The loss terms of a step's loss dict (the CenterNet or the MLP
    head's), without check_gradients' entries."""
    return [k for k in losses if k not in ("grad_norm", "grads_finite")]


def port_model(spec, variables, dtype=torch.float32):
    model = port_det.MultiModal3DDetector(to_port_spec(spec)).to(dtype)
    return load_jax_variables(model, variables)


def state_dict_of(spec, tree, batch_stats):
    """A JAX-layout params tree (parameters or AdamW moments) as the port's
    state_dict tensors, in float64."""
    return port_model(spec, {"params": tree, "batch_stats": batch_stats}, torch.float64).state_dict()


def port_step_from(spec, variables, record=None, train_spec=TRAIN, dtype=torch.float32, **kw):
    """A port train step on a fresh model of `dtype` holding `variables`
    and, from a JAX record, that record's AdamW moments after one update."""
    model = port_model(spec, variables, dtype)
    port_spec = port_config.TrainSpec(**dataclasses.asdict(train_spec))
    opt = port_loop.make_optimizer(port_spec, COMPAT)
    step = port_loop.make_train_step(model, opt, port_spec, COMPAT, device="cpu", **kw)
    if record is not None:
        mu = state_dict_of(spec, record["mu"], variables["batch_stats"])
        nu = state_dict_of(spec, record["nu"], variables["batch_stats"])
        for name, p in model.named_parameters():
            opt.adamw.state[p] = {"step": torch.tensor(1.0), "exp_avg": mu[name].to(p.dtype),
                                  "exp_avg_sq": nu[name].to(p.dtype)}
        opt.updates = 1
    return model, opt, step


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def first_moments(model, opt):
    return {name: opt.adamw.state[p]["exp_avg"].double() for name, p in model.named_parameters()}


def port_layout(spec, record, batch_stats):
    """A JAX record (losses, variables, AdamW moments) in the port's
    state_dict layout, float64."""
    return {"losses": record["losses"],
            "state": state_dict_of(spec, record["variables"]["params"], record["variables"]["batch_stats"]),
            "mu": state_dict_of(spec, record["mu"], batch_stats)}


def port_record(model, opt, losses):
    """The same record of a port step."""
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": {k: v.double().clone() for k, v in model.state_dict().items()},
            "mu": {k: v.clone() for k, v in first_moments(model, opt).items()}}


def assert_step_matches(got, want, prev_mu, grad_norm_rtol=1e-5):
    """One port step's record against a float64 record of the same step
    (both in the port's layout; `prev_mu` the first moments before it), at
    the limits of test_torch_train.py's docstring."""
    for k in loss_keys(want["losses"]):
        np.testing.assert_allclose(got["losses"][k], want["losses"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["losses"]["grad_norm"], want["losses"]["grad_norm"], rtol=grad_norm_rtol)
    assert got["losses"]["grads_finite"] == 1.0

    b1 = TRAIN.betas[0]
    mu_want = want["mu"]
    largest = max(float(mu_want[k].abs().max()) for k in got["mu"])
    zero_grad = []
    for name, m in got["mu"].items():
        top = float(mu_want[name].abs().max())
        if top < 1e-9 * largest or name.endswith(ZERO_GRADIENT):
            # a bias right before a BatchNorm, or an attention key's bias
            assert top <= 1e-5 * largest, name
            zero_grad.append(name)
            assert float(m.abs().max()) <= 1e-5 * largest, name
            small = torch.ones_like(m, dtype=torch.bool)
        else:
            err = float((m - mu_want[name]).abs().max())
            assert err <= 1e-4 * top, f"{name}: first moment off by {err / top:.3g} of its largest"
            # this step's clipped gradient, from the reference's moments
            g = (mu_want[name] - (0 if prev_mu is None else b1 * prev_mu[name])).abs()
            small = g < 1e-3 * g.max()
        diff = (got["state"][name] - want["state"][name]).abs()
        assert _max(diff[~small]) <= 1e-6, name
        assert _max(diff[small]) <= 2 * LR, name
    assert zero_grad, "the narrow detector has biases before BatchNorms"
    for name, v in want["state"].items():
        if name.endswith("running_var"):
            np.testing.assert_allclose(got["state"][name], v, rtol=1e-5, err_msg=name)
        elif name.endswith("running_mean"):
            np.testing.assert_allclose(got["state"][name], v, rtol=0, atol=1e-5 * float(v.abs().max()),
                                       err_msg=name)


def train_runs(mode):
    """The batches, variables and the reference's (exact) records of two
    steps for `mode`: pseudo takes uint8 cameras and 9-column boxes,
    geometric float cameras and 7-column boxes (Q12: zero velocity
    targets)."""
    spec = train_spec_of(mode)
    batches = make_batches(spec, n_cols=9 if mode == "pseudo" else 7, uint8=mode == "pseudo")
    variables = make_variables(spec, batches[0])
    return {"spec": spec, "batches": batches, "variables": variables,
            "exact": jax_steps(spec, variables, batches, exact=True)}


def check_step(runs, step, dtype=torch.float64):
    """Port step `step` (0 or 1) of `dtype`, from the reference's state
    before it, against the reference's step at fixed limits; no kernel
    launches.

    In f32, where rounding took the other side of a kink than float64 (a
    ReLU input within ~1e-6 of 0, or a max-pool window's two largest inputs
    within ~1e-7 of each other; chip_smoke.TieSides), the gradient has no
    single value and the reference's is not the one to hold the step to.
    Then the f32 step is held, at the same limits, to the port's float64
    step from the same state on the f32 step's side of each such tie (each
    within 1e-5 of its tensor's largest), and its loss terms still to the
    reference's."""
    spec, exact = runs["spec"], runs["exact"]
    start = runs["variables"] if step == 0 else exact[step - 1]["variables"]
    record = None if step == 0 else exact[step - 1]
    batch, bs = runs["batches"][step], runs["variables"]["batch_stats"]
    prev_mu = None if record is None else state_dict_of(spec, record["mu"], bs)
    counters = (pointnet_fused.pointnet_fused, bev_pool.bev_pool_weighted_rows)
    before = [k.launches for k in counters]
    model, opt, train_step = port_step_from(spec, start, record, dtype=dtype, check_gradients=True)
    ties = TieSides()
    with ties.record():
        got = port_record(model, opt, train_step(batch))
    assert train_step.step == 1 and opt.updates == step + 1
    assert all(p.dtype == dtype for p in model.det_head.parameters())
    want = port_layout(spec, exact[step], bs)
    if dtype != torch.float64:
        ref_model, ref_opt, ref_step = port_step_from(spec, start, record, dtype=torch.float64,
                                                      check_gradients=True)
        with ties.replay():
            replayed = port_record(ref_model, ref_opt, ref_step(batch))
        assert ties.flip_share <= 1e-5, ties.flip_share
        if ties.flips:
            for k in loss_keys(want["losses"]):
                np.testing.assert_allclose(got["losses"][k], want["losses"][k], rtol=1e-5, err_msg=k)
            want = replayed
    assert_step_matches(got, want, prev_mu, 1e-5 if dtype == torch.float64 else 1e-4)
    # training runs the point encoders' plain chain and the matmul splat
    assert [k.launches for k in counters] == before
    return ties.flips
