"""BEV pools B2 and B3, their chunk plans and the frustum geometry in the
PyTorch port against the JAX package.

The host-side plans and frustum cells must be bit-identical. The pools run
their plain versions here; the JAX side runs the Pallas kernels in
interpret mode, as tests/test_bev_pool_pallas.py does. f32 sums in another
order: tolerance 1e-5. tests/test_torch_kernels_cuda.py holds the kernels
against their plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.ops import bev_pool_pallas as jax_pool
from bevfusion_multimodal_3d_object_detection_tpu.ops import bev_splat as jax_splat
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_pool
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.bev_splat import precompute_frustum_cells
from chip_smoke import ring_camera_cells

TOL = 1e-5
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
PLAN_KEYS = ("point_idx", "local_ids", "block_idx")


def _ids(kind, rng, p, num_cells):
    if kind == "ring":
        return ring_camera_cells((448, 800), (50, 50), 40, 1.0, 60.0, PC_RANGE)[2].reshape(-1)
    if kind in ("random", "bf16"):
        ids = rng.randint(0, num_cells, p).astype(np.int32)
        ids[rng.rand(p) < 0.3] = -1
        return ids
    if kind == "long cell":  # 60 % of the points in one cell, a few in its neighbours
        ids = rng.randint(0, num_cells, p).astype(np.int32)
        ids[: 6 * p // 10] = 450
        ids[6 * p // 10: 7 * p // 10] = rng.randint(440, 460, p // 10)
        return rng.permutation(ids)
    return np.full(p, -1, np.int32)  # every point out of range


@pytest.mark.parametrize("kind", ["ring", "random", "all-out-of-range"])
def test_chunk_plan_is_bit_identical(kind):
    ids = _ids(kind, np.random.RandomState(0), 3000, 2500)
    want = jax_pool.precompute_bev_chunks(ids, 2500)
    got = bev_pool.precompute_bev_chunks(ids, 2500)
    assert got["num_cells_pad"] == want["num_cells_pad"] == bev_pool.num_cells_padded(2500)
    for k in PLAN_KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_frustum_cells_are_bit_identical():
    rng = np.random.RandomState(1)
    intr = np.array([[600.0, 0, 410], [0, 590.0, 230], [0, 0, 1]])
    q, _ = np.linalg.qr(rng.randn(3, 3))
    args = (intr, q, rng.randn(3), (28, 50), (448, 800), np.linspace(1.0, 60.0, 40),
            (50, 50), PC_RANGE)
    got = precompute_frustum_cells(*args)
    want = jax_splat.precompute_frustum_cells(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert 0 < (got >= 0).mean() < 1


def _plans(ids_rows, num_cells):
    plans = [bev_pool.precompute_bev_chunks(r, num_cells) for r in ids_rows]
    return {k: np.stack([p[k] for p in plans]) for k in PLAN_KEYS}, plans[0]["num_cells_pad"]


def _weighted_case(seed, x=2, hw=72, c=16, d=8, num_cells=900):
    """The JAX weighted-pool test size: X = 2 rows of 6x12 pixels, C = 16,
    D = 8 depth bins, 900 cells."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(x, hw, c).astype(np.float32)
    logits = rng.randn(x, d, hw)  # depth probabilities, p = d * HW + pixel
    weights = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).reshape(x, -1).astype(np.float32)
    plans, pad = _plans([_ids("random", rng, d * hw, num_cells) for _ in range(x)], num_cells)
    return feats, weights, plans, pad


def _jax_weighted(feats, weights, plans, num_cells, pad, feat_dtype=jnp.float32):
    return np.asarray(jax_pool.bev_pool_weighted_rows(
        jnp.asarray(feats, feat_dtype), jnp.asarray(weights),
        *(jnp.asarray(plans[k]) for k in PLAN_KEYS),
        num_cells=num_cells, num_cells_pad=pad, interpret=True,
    ))


def _port_args(plans):
    return [torch.from_numpy(plans[k]) for k in PLAN_KEYS]


def test_weighted_pool_matches_jax():
    feats, weights, plans, pad = _weighted_case(0)
    want = _jax_weighted(feats, weights, plans, 900, pad)
    got = bev_pool.bev_pool_weighted_rows(
        torch.from_numpy(feats), torch.from_numpy(weights), *_port_args(plans), 900, pad
    )
    assert got.dtype == torch.float32 and got.shape == (2, 900, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert np.abs(want).max() > 0.5


def test_weighted_pool_rounds_weights_to_bf16_features():
    """bf16 features: each f32 weight is rounded to bf16 before the product
    (bev_pool_pallas.py:150); the products are exact and summed in f32."""
    feats, weights, plans, pad = _weighted_case(1)
    feats_bf16 = torch.from_numpy(feats).bfloat16()
    want = _jax_weighted(feats_bf16.float().numpy(), weights, plans, 900, pad, jnp.bfloat16)
    got = bev_pool.bev_pool_weighted_rows(
        feats_bf16, torch.from_numpy(weights), *_port_args(plans), 900, pad
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    unrounded = bev_pool.bev_pool_weighted_rows(
        feats_bf16.float(), torch.from_numpy(weights), *_port_args(plans), 900, pad
    ).numpy()
    assert np.abs(unrounded - want).max() > 100 * TOL  # the rounding is seen


@pytest.mark.parametrize("kind", ["random", "all-out-of-range", "long cell", "bf16"])
def test_sorted_pool_matches_jax(kind):
    """Random cells, none in range, one cell holding 60 % of each row (it
    spans many chunks of a window), and bf16 features: JAX's bf16 products
    are exact and summed in f32, the port's plain version gathers the bf16
    features and sums them in f32."""
    rng = np.random.RandomState(2)
    p, c, num_cells = 1000, 16, 900
    feats = rng.randn(2, p, c).astype(np.float32)
    plans, pad = _plans([_ids(kind, rng, p, num_cells) for _ in range(2)], num_cells)
    dtype = (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else (jnp.float32, torch.float32)
    want = np.asarray(jax_pool.bev_pool_rows(
        jnp.asarray(feats, dtype[0]), *(jnp.asarray(plans[k]) for k in PLAN_KEYS),
        num_cells=num_cells, num_cells_pad=pad, interpret=True,
    ))
    got = bev_pool.bev_pool_rows(torch.from_numpy(feats).to(dtype[1]), *_port_args(plans), num_cells, pad)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if kind == "all-out-of-range":
        assert np.all(got.numpy() == 0.0)
    if kind == "long cell":
        assert (plans["local_ids"] >= 0).sum(2).max() == plans["local_ids"].shape[2]  # full chunks
        assert np.abs(want[:, 450]).max() > 10  # the long cell's sum is there
    if kind == "bf16":  # the features are rounded to bf16 before the sum
        f32 = bev_pool.bev_pool_rows(torch.from_numpy(feats), *_port_args(plans), num_cells, pad).numpy()
        assert np.abs(f32 - want).max() > 100 * TOL


def test_cells_past_num_cells_are_dropped():
    """A plan over 1024 cells pooled into 1000: the last window's cells
    >= 1000 are dropped, as the JAX wrapper's out[:num_cells] does."""
    feats, weights, _, _ = _weighted_case(3)
    rng = np.random.RandomState(3)
    plans, pad = _plans([rng.randint(0, 1024, 576).astype(np.int32) for _ in range(2)], 1024)
    want = _jax_weighted(feats, weights, plans, 1000, pad)
    got = bev_pool.bev_pool_weighted_rows(
        torch.from_numpy(feats), torch.from_numpy(weights), *_port_args(plans), 1000, pad
    )
    assert got.shape == (2, 1000, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_wrappers_check_inputs():
    feats, weights, plans, pad = _weighted_case(4)
    f, w = torch.from_numpy(feats), torch.from_numpy(weights)
    pi, li, bi = _port_args(plans)
    with pytest.raises(TypeError):
        bev_pool.bev_pool_weighted_rows(f.double(), w, pi, li, bi, 900, pad)
    with pytest.raises(TypeError):
        bev_pool.bev_pool_weighted_rows(f, w, pi.long(), li, bi, 900, pad)
    with pytest.raises(ValueError):
        bev_pool.bev_pool_weighted_rows(f, w[:1], pi, li, bi, 900, pad)
    with pytest.raises(ValueError):
        bev_pool.bev_pool_rows(f, pi, li[:, :-1], bi, 900, pad)
    with pytest.raises(ValueError):
        bev_pool.bev_pool_rows(f, pi, li, bi, 900, 1000)  # pad not whole windows


def test_cpu_path_does_not_count_launches():
    feats, weights, plans, pad = _weighted_case(5)
    before = (bev_pool.bev_pool_weighted_rows.launches, bev_pool.bev_pool_rows.launches)
    bev_pool.bev_pool_weighted_rows(
        torch.from_numpy(feats), torch.from_numpy(weights), *_port_args(plans), 900, pad
    )
    bev_pool.bev_pool_rows(torch.from_numpy(feats), *_port_args(plans), 900, pad)
    assert (bev_pool.bev_pool_weighted_rows.launches, bev_pool.bev_pool_rows.launches) == before
