"""The scatter and culled lift-splats of the PyTorch port against the JAX
package: `bev_scatter_add`, the shared-plan `lift_splat` and
`lift_splat_matmul`, the culled pair plans (int for int), the two culled
splats, `GeometricCameraBEV` in ``scatter`` and ``culled`` modes (eval and
train), the culled splat's gradients, a culled train step against JAX's
float64 step, and the dataset's pair plans against the JAX dataset's.

f32 on the CPU with jax_default_matmul_precision="highest" (conftest).
Tolerance 1e-5 of each output's scale: the same f32 sums in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.data import dataset as jax_dataset
from bevfusion_multimodal_3d_object_detection_tpu.models import fusion as jax_fusion
from bevfusion_multimodal_3d_object_detection_tpu.ops import bev_splat as jax_splat
from bevfusion_multimodal_3d_object_detection_tpu_torch.data import dataset as port_dataset
from bevfusion_multimodal_3d_object_detection_tpu_torch.models import fusion as port_fusion
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_splat as port_splat
from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.convert import load_jax_variables
from chip_smoke import ring_camera_cells, ring_calibrate_infos
from torch_port_helpers import narrow_spec, random_variables, to_port_spec
from torch_train_helpers import check_step, train_runs
from torch_trainer_helpers import jax_native_of_its_own  # noqa: F401 (autouse: JAX's LiDAR prep of the module's own)
from torch_trainer_helpers import tree_config, write_test_tree

TOL = 1e-5
KEY = jax.random.PRNGKey(0)
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
PAIR_KEYS = ("seg_idx", "seg_id", "pair_cell", "pair_pix")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.1
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * scale)


def _ring(d=8, image=(128, 256), bev=(50, 50)):
    """(6, D, H', W') ring-calibration cells: hw = 8 x 16 pixels a camera."""
    return ring_camera_cells(image, bev, d, 1.0, 60.0, PC_RANGE)


def _plans(cells, num_cells, **kw):
    hw = cells.shape[-2] * cells.shape[-1]
    plans, caps = port_splat.precompute_culled_pairs_batch(cells, hw, num_cells, **kw)
    return plans, caps


def test_bev_scatter_add_matches_jax():
    """Leading axes (2, 3), ids -1, in range and past num_cells."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 3, 200, 6).astype(np.float32)
    ids = rng.randint(-3, 60, (2, 3, 200)).astype(np.int32)
    want = jax_splat.bev_scatter_add(jnp.asarray(feats), jnp.asarray(ids), 50)
    got = port_splat.bev_scatter_add(torch.from_numpy(feats), torch.from_numpy(ids), 50)
    assert got.shape == (2, 3, 50, 6)
    _close(got, want)


@pytest.mark.parametrize("fn", ["lift_splat", "lift_splat_matmul"])
def test_shared_plan_splats_match_jax(fn):
    rng = np.random.RandomState(1)
    b, fh, fw, c, d = 3, 8, 16, 16, 8
    feats = rng.randn(b, fh, fw, c).astype(np.float32)
    logits = rng.randn(b, fh, fw, d).astype(np.float32)
    cells = _ring(d)[2]  # (D, H', W'): one camera's plan shared by the batch
    want = getattr(jax_splat, fn)(jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(cells), 2500)
    got = getattr(port_splat, fn)(_nchw(feats), _nchw(logits), torch.from_numpy(cells), 2500)
    _close(got, want)


@pytest.mark.parametrize("case", ["padded", "exact-fit", "headroom", "overflow", "one-camera"])
def test_culled_plans_equal_jax(case):
    """The plans are JAX's int for int: pads (trash coordinates past the
    cells, zero gathers), capacities from counts, and the overflow error."""
    cells = _ring(8, bev=(20, 20))
    hw, nc = 128, 400
    if case == "overflow":
        for mod in (jax_splat, port_splat):
            with pytest.raises(ValueError, match="splat_cull_points"):
                mod.precompute_culled_pairs(cells[0].reshape(-1), hw, nc, point_capacity=8, pair_capacity=8)
        return
    if case == "one-camera":
        a = jax_splat.precompute_culled_pairs(cells[1].reshape(-1), hw, nc)
        b = port_splat.precompute_culled_pairs(cells[1].reshape(-1), hw, nc)
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype and np.array_equal(b[k], a[k]), k
        return
    kw = {"padded": {}, "headroom": {"headroom": 1.05, "pad_multiple": 64}}.get(case)
    if case == "exact-fit":
        sizes = [port_splat.precompute_culled_pairs(c.reshape(-1), hw, nc, pad_multiple=1) for c in cells]
        kw = {"point_capacity": max(s["n_points"] for s in sizes),
              "pair_capacity": max(s["n_pairs"] for s in sizes)}
    want, want_caps = jax_splat.precompute_culled_pairs_batch(cells, hw, nc, **kw)
    got, got_caps = port_splat.precompute_culled_pairs_batch(cells, hw, nc, **kw)
    assert got_caps == want_caps and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert port_splat.precompute_culled_pairs_batch(cells, hw, nc, sizes_only=True, **kw) == (None, want_caps)
    n_pairs = got["n_pairs"]
    if case == "exact-fit":  # the largest camera fills its plan, pads only on the others
        assert got["pair_cell"].shape[1] == n_pairs.max()
    else:
        assert (got["pair_cell"][0, n_pairs[0]:] >= nc).all() and (got["seg_idx"][0, got["n_points"][0]:] == 8 * hw).all()


def _culled_case(seed=2, x=6, c=16):
    rng = np.random.RandomState(seed)
    d = 8
    feats = rng.randn(x, 8, 16, c).astype(np.float32)
    logits = 2 * rng.randn(x, 8, 16, d).astype(np.float32)
    plans, _ = _plans(_ring(d), 2500, headroom=1.05)
    return feats, logits, [plans[k] for k in PAIR_KEYS]


@pytest.mark.parametrize("fn", ["lift_splat_culled_rows", "lift_splat_culled_gather_rows"])
def test_culled_splats_match_jax(fn):
    feats, logits, plans = _culled_case()
    want = getattr(jax_splat, fn)(jnp.asarray(feats), jnp.asarray(logits), *map(jnp.asarray, plans), 2500)
    got = getattr(port_splat, fn)(_nchw(feats), _nchw(logits), *map(torch.from_numpy, plans), 2500)
    _close(got, want)
    # the matmul splat over the uncompacted cells gives the same sums
    cells = torch.from_numpy(_ring(8).reshape(6, -1))
    _close(got, port_splat.lift_splat_matmul_rows(_nchw(feats), _nchw(logits), cells, 2500).numpy())


def test_culled_gradients_match_jax():
    """d(sum of squares)/d(features, logits) through the culled splat: what
    reaches depth_head and feat_proj in training."""
    feats, logits, plans = _culled_case(seed=3)

    def loss(f, lg):
        return jnp.sum(jax_splat.lift_splat_culled_rows(f, lg, *map(jnp.asarray, plans), 2500) ** 2)

    want_f, want_l = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(logits))
    f, lg = _nchw(feats).requires_grad_(), _nchw(logits).requires_grad_()
    port_splat.lift_splat_culled_rows(f, lg, *map(torch.from_numpy, plans), 2500).pow(2).sum().backward()
    _close(f.grad.numpy(), np.moveaxis(np.asarray(want_f), -1, 1))
    _close(lg.grad.numpy(), np.moveaxis(np.asarray(want_l), -1, 1))


def _module_case(mode, seed):
    """GeometricCameraBEV at a 10x10 grid on random cells (with -1s), and
    for culled their pair plans."""
    spec = narrow_spec(bev=10, camera_to_bev="geometric", depth_bins=4, splat_mode=mode).bev
    rng = np.random.RandomState(seed)
    feats = rng.randn(2, 6, 2, 4, 24).astype(np.float32)
    cells = rng.randint(-1, 100, (2, 6, 4, 2, 4)).astype(np.int32)
    pairs = None
    if mode == "culled":
        stacked, _ = port_splat.precompute_culled_pairs_batch(cells.reshape(12, -1), 8, 100, headroom=1.05)
        pairs = tuple(stacked[k].reshape((2, 6) + stacked[k].shape[1:]) for k in PAIR_KEYS)
    return spec, feats, cells, pairs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", ["scatter", "culled"])
def test_geometric_camera_bev_matches_jax(mode, train):
    """The culled module gets pair plans only (no cells), as the dataset
    ships them; train mode normalizes with batch statistics."""
    spec, feats, cells, pairs = _module_case(mode, seed=4)
    jax_mod = jax_fusion.GeometricCameraBEV(spec=spec)
    jax_cells = None if pairs else jnp.asarray(cells)
    jax_pairs = None if pairs is None else tuple(map(jnp.asarray, pairs))
    variables = random_variables(jax_mod.init({"params": KEY}, jnp.asarray(feats), jnp.asarray(cells)), seed=5)
    if train:
        want, mutated = jax_mod.apply(variables, jnp.asarray(feats), jax_cells, train=True,
                                      camera_pairs=jax_pairs, mutable=["batch_stats"])
    else:
        want = jax_mod.apply(variables, jnp.asarray(feats), jax_cells, camera_pairs=jax_pairs)
    port = load_jax_variables(port_fusion.GeometricCameraBEV(to_port_spec(spec), 24), variables).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(feats).permute(0, 1, 4, 2, 3), None if pairs else torch.from_numpy(cells),
                   None, None if pairs is None else tuple(map(torch.from_numpy, pairs)))
    _close(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))
    if train:
        stats = mutated["batch_stats"]["splat_refine_bn"]
        np.testing.assert_allclose(port.splat_refine_bn.running_mean.numpy(), stats["mean"], rtol=0,
                                   atol=TOL * float(np.abs(stats["mean"]).max()))
        np.testing.assert_allclose(port.splat_refine_bn.running_var.numpy(), stats["var"], rtol=TOL)


def test_culled_without_pairs_takes_the_matmul_splat():
    """A followed JAX quirk: culled with no pair plans falls back to the
    matmul splat (JAX fusion.py:142-148), which then needs the cells."""
    spec, feats, cells, _ = _module_case("culled", seed=6)
    port = port_fusion.GeometricCameraBEV(to_port_spec(spec), 24).eval()
    matmul = port_fusion.GeometricCameraBEV(to_port_spec(dataclasses.replace(spec, splat_mode="matmul")), 24)
    matmul.load_state_dict(port.state_dict())
    x, c = torch.from_numpy(feats).permute(0, 1, 4, 2, 3), torch.from_numpy(cells)
    with torch.no_grad():
        torch.testing.assert_close(port(x, c), matmul.eval()(x, c), rtol=0, atol=0)
        with pytest.raises(ValueError, match="camera_cells"):
            port(x, None)


@pytest.fixture(scope="module")
def culled_runs():
    return train_runs("culled", steps=1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "f32"])
def test_culled_train_step_matches_jax(culled_runs, dtype):
    """One train step on the culled splat (pair plans in the batch, no
    cells) against JAX's float64 step, at test_torch_train.py's limits."""
    assert "camera_cells" not in culled_runs["batches"][0]
    check_step(culled_runs, 0, dtype)


@pytest.fixture(scope="module")
def culled_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("culled")
    write_test_tree(root, samples_per_split=3, n_points=300)
    ring_calibrate_infos(root, ("train", "val"), seed=3)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_pair_plans_match_jax(culled_tree, split):
    """splat_mode: culled ships the pair plans (no cells) on every split,
    equal to the JAX dataset's, with capacities from sample 0; two loader
    threads give the same batches."""
    cfg = tree_config(culled_tree, culled_tree)
    cfg["model"]["bev_fusion"].update(camera_to_bev="geometric", splat_mode="culled", depth_bins=8)
    jax_ds = jax_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
    port_ds = port_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
    keys = {f"camera_{k}" for k in PAIR_KEYS}
    for i in (2, 0, 1):  # sample 0 sizes the capacities whichever comes first
        got, want = port_ds[i], jax_ds[i]
        assert "camera_cells" not in got and keys <= set(got)
        for k in keys:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)
    assert port_ds._cull_caps == jax_ds._cull_caps and (got["camera_seg_id"] > 0).any()
    batches = {}
    for workers in (0, 2):
        ds = port_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
        loader = port_dataset.DataLoader(ds, batch_size=3, num_workers=workers, prefetch=0)
        batches[workers] = next(iter(loader))
    want = jax_dataset.collate_fn([jax_ds[i] for i in range(3)])
    for k in keys:
        assert np.array_equal(batches[0][k], want[k]) and np.array_equal(batches[2][k], want[k]), k
    # the config's capacities, when both are given, win over sample 0's
    cfg["model"]["bev_fusion"].update(splat_cull_points=4096, splat_cull_pairs=2048)
    ds = port_dataset.NuScenesDataset(split=split, config=cfg, seed=3)
    assert ds[0]["camera_seg_idx"].shape == (6, 4096) and ds[0]["camera_pair_cell"].shape == (6, 2048)
