"""The port's hand-written kernels on a card, against their plain PyTorch
versions: B1 (fused PointNet) and the BEV pools B2 and B3; B1's custom op
against the ctypes launch it wraps (bit for bit: one kernel), and a serving
artifact exported on the card.

This file imports neither jax, flax nor the JAX package, so that on a machine
with a card

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

runs every kernel test. The `cuda`-marked tests skip without a card. The
plain versions are the oracles: f32 sums in another order, tolerance 1e-5
(B2 and B3: of the sum of the terms' magnitudes, as chip_smoke.py phase 6
holds them, since long sums of random terms cancel).
"""

import pathlib

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import bev_pool
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops import pointnet_fused as pf
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.pointnet_fused import (
    kernel_tile_points,
    pointnet_fused,
    pointnet_fused_reference,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.tools import b2_ablation
from chip_smoke import long_cell_cells, ring_camera_cells

TOL = 1e-5
PC_RANGE = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
PLAN_KEYS = ("point_idx", "local_ids", "block_idx")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# B1


def _chain(rng, widths):
    ws = [(rng.randn(a, b) / np.sqrt(a)).astype(np.float32) for a, b in zip(widths[:-1], widths[1:])]
    bs = [(rng.randn(b) * 0.1).astype(np.float32) for b in widths[1:]]
    return ws, bs


def _points(rng, b, n, c):
    x = rng.randn(b, n, c).astype(np.float32)
    x[0, n // 2:] = 0.0  # zero padding
    x[-1] = 0.0  # a row with every point masked
    return x


@pytest.mark.cuda
def test_kernel_matches_reference_on_card(cuda_device):
    rng = np.random.RandomState(3)
    ws, bs = _chain(rng, (4, 64, 128, 256))
    x = torch.from_numpy(_points(rng, 2, 1000, 4)).to(cuda_device)
    wt = [torch.from_numpy(w).to(cuda_device) for w in ws]
    bt = [torch.from_numpy(b).to(cuda_device) for b in bs]
    torch.backends.cuda.matmul.allow_tf32 = False
    for mask in (False, True):
        got = pointnet_fused(x, wt, bt, mask)
        want = pointnet_fused_reference(x, wt, bt, mask)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mask_padding", [False, True])
@pytest.mark.parametrize(
    "widths,edge",
    [
        ((4, 64, 128, 256), "one past a tile"),
        ((4, 64, 128, 256), "under one tile"),
        ((4, 32, 50, 64, 96, 66), "one past a tile"),
        ((4, 64, 528, 264), "one past a tile"),
        ((5, 64, 128, 256, 512, 1024), "one past a tile"),
    ],
    ids=["blocked-n1", "blocked-under", "ragged-widths", "partial-n-slabs", "multi-sweep-c5"],
)
def test_f32_kernel_tile_edges_on_card(cuda_device, mask_padding, widths, edge):
    """The f32 kernel at the edges of its own tile (N = 1 mod it, N below
    it), on a chain whose widths are not multiples of 4, where FMA loops run
    before, between and after a register-blocked layer, on blocked layers
    whose last N-slab is partial, and on the multi-sweep LiDAR chain's five
    input channels."""
    tile = kernel_tile_points(torch.float32, widths)
    assert tile in (16, 32, 64)
    n = 5 * tile + 1 if edge == "one past a tile" else tile - 1
    rng = np.random.RandomState(4)
    ws, bs = _chain(rng, widths)
    x = torch.from_numpy(_points(rng, 3, n, widths[0])).to(cuda_device)
    wt = [torch.from_numpy(w).to(cuda_device) for w in ws]
    bt = [torch.from_numpy(b).to(cuda_device) for b in bs]
    torch.backends.cuda.matmul.allow_tf32 = False
    got = pointnet_fused(x, wt, bt, mask_padding)
    want = pointnet_fused_reference(x, wt, bt, mask_padding)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if mask_padding:
        assert torch.all(got[-1] == 0)  # all-masked row -> 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,widths", [((40, 125), (7, 32, 64, 128, 256)), ((2, 3001), (4, 64, 128, 256, 512))],
                         ids=["radar", "ragged-lidar"])
def test_custom_op_matches_ctypes_path_on_card(cuda_device, dtype, shape, widths):
    """`pointnet_fused` (the custom op bmod_torch::pointnet_fused) against
    the ctypes launch it wraps: the same kernel, so the same bits; each
    counts one launch."""
    rng = np.random.RandomState(5)
    ws, bs = _chain(rng, widths)
    x = torch.from_numpy(_points(rng, *shape, widths[0])).to(cuda_device, dtype)
    wt = [torch.from_numpy(w).to(cuda_device, dtype) for w in ws]
    bt = [torch.from_numpy(b).to(cuda_device) for b in bs]
    for mask in (False, True):
        before = pointnet_fused.launches
        got = pointnet_fused(x, wt, bt, mask)
        want = pf._launch(x, wt, bt, mask)
        torch.cuda.synchronize()
        assert pointnet_fused.launches == before + 2
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_aot_artifact_exported_on_card_serves(cuda_device, tmp_path):
    """A narrow model's artifact exported on the card (bf16, folded BN)
    serves with B1 launches > 0 and the live server's detections (scores
    1e-4, boxes 1e-3: the serving tolerances)."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.aot import export_serving_artifact
    from chip_smoke import detections_agree, make_samples

    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "base.yaml"))
    m = cfg["model"]
    m["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    m["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    m["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    m["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    m["centernet_head"].update(in_channels=32, head_conv=16)
    kw = dict(config=cfg, batch_size=2, score_threshold=0.0, use_bf16=True, fold_bn=True, device="cuda")
    live = InferenceServer(**kw)
    path = tmp_path / "serving.aot.npz"
    assert export_serving_artifact(live, path)["platforms"] == ["cuda"]
    aot = InferenceServer(**kw, aot_path=str(path))
    samples = make_samples(live.spec, np.random.RandomState(3), 2)
    pointnet_fused.launches = 0
    got = aot._run_batch(samples)
    assert pointnet_fused.launches > 0
    detections_agree(got, live._run_batch(samples), "AOT vs live server on the card")


# ---------------------------------------------------------------------------
# B2 and B3


def _plans(ids_rows, num_cells):
    plans = [bev_pool.precompute_bev_chunks(r, num_cells) for r in ids_rows]
    return {k: np.stack([p[k] for p in plans]) for k in PLAN_KEYS}, plans[0]["num_cells_pad"]


def _weighted_case(seed, x=2, hw=72, c=16, d=8, num_cells=900):
    """X rows of `hw` pixels, C channels, D depth bins; random cell ids,
    30 % out of range."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(x, hw, c).astype(np.float32)
    logits = rng.randn(x, d, hw)  # depth probabilities, p = d * HW + pixel
    weights = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).reshape(x, -1).astype(np.float32)
    ids = []
    for _ in range(x):
        row = rng.randint(0, num_cells, d * hw).astype(np.int32)
        row[rng.rand(d * hw) < 0.3] = -1
        ids.append(row)
    plans, pad = _plans(ids, num_cells)
    return feats, weights, plans, pad


def _on(device, plans):
    return [torch.from_numpy(plans[k]).to(device) for k in PLAN_KEYS]


def _assert_pool_close(got, features, weights, plan, num_cells, pad):
    """`got` against the plain B2 (B3 where `weights` is None) within TOL of
    the sum of each output's terms' magnitudes (plus 2^-4 of their mean), as
    phase 6 of chip_smoke.py."""
    if weights is None:
        want = bev_pool.bev_pool_sorted_reference(features, *plan, num_cells, pad)
        scale = bev_pool.bev_pool_sorted_reference(features.abs(), *plan, num_cells, pad)
    else:
        want = bev_pool.bev_pool_weighted_reference(features, weights, *plan, num_cells, pad)
        scale = bev_pool.bev_pool_weighted_reference(features.abs(), weights, *plan, num_cells, pad)
    limit = TOL * (scale + 2.0 ** -4 * scale.mean())
    assert got.shape == want.shape and got.dtype == torch.float32
    worst = ((got - want).abs() / limit.clamp_min(1e-30)).max().item()
    assert worst <= 1.0, f"worst {worst:.3g} of the limit"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(cuda_device, dtype):
    feats, weights, plans, pad = _weighted_case(6, c=160)
    f = torch.from_numpy(feats).to(cuda_device, dtype)
    w = torch.from_numpy(weights).to(cuda_device)
    args = _on(cuda_device, plans)
    got = bev_pool.bev_pool_weighted_rows(f, w, *args, 900, pad)
    want = bev_pool.bev_pool_weighted_reference(f, w, *args, 900, pad)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    rng = np.random.RandomState(7)
    pts = torch.from_numpy(rng.randn(2, 576, 160).astype(np.float32)).to(cuda_device, dtype)
    got = bev_pool.bev_pool_rows(pts, *args, 900, pad)
    want = bev_pool.bev_pool_sorted_reference(pts, *args, 900, pad)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the kernel loads 16 bytes of channels at a time: other widths raise
    with pytest.raises(ValueError, match="multiple of"):
        bev_pool.bev_pool_rows(pts[..., :6].contiguous(), *args, 900, pad)


def _long_cell_case(rows=2, hw=1400, d=40, c=256):
    """Ring-calibration-sized rows whose entries mostly fall in one cell
    (chip_smoke.long_cell_cells), so the cell crosses many of a block's
    warp segments."""
    plans, pad = _plans(long_cell_cells(rows, d, hw, 2500).reshape(rows, -1), 2500)
    rng = np.random.RandomState(8)
    feats = rng.randn(rows, hw, c).astype(np.float32)
    weights = rng.rand(rows, d * hw).astype(np.float32)
    return feats, weights, plans, pad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["long cell across segments", "6 ring rows", "sorted kernel variant"])
def test_weighted_pool_kernel_cases_on_card(cuda_device, dtype, case):
    """B2 where one cell spans several warp segments (combined in the block),
    at 6 ring-calibration rows (fewer blocks than SMs: narrower slices), and
    at rows too long for shared memory (B3's sorted kernel, weighted); each
    within TOL of the terms' magnitudes, and two launches equal bit for bit."""
    if case == "long cell across segments":
        feats, weights, plans, pad = _long_cell_case()
        num_cells = 2500
    elif case == "6 ring rows":
        cells = ring_camera_cells((448, 800), (50, 50), 40, 1.0, 60.0, PC_RANGE)
        plans, pad = _plans(cells.reshape(6, -1), 2500)
        rng = np.random.RandomState(9)
        feats = rng.randn(6, 1400, 256).astype(np.float32)
        logits = rng.randn(6, 40, 1400)
        weights = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).reshape(6, -1).astype(np.float32)
        num_cells = 2500
    else:  # 16,384 pixels: even 16 bytes a pixel exceed a block's shared memory
        feats, weights, plans, pad = _weighted_case(10, hw=16384, c=8, d=2)
        num_cells = 900
    f = torch.from_numpy(feats).to(cuda_device, dtype)
    w = torch.from_numpy(weights).to(cuda_device)
    plan = _on(cuda_device, plans)
    config = bev_pool.weighted_config(f, plan[0].shape[1])
    assert (config["slice_channels"] == 0) == (case == "sorted kernel variant"), config
    got = bev_pool.bev_pool_weighted_rows(f, w, *plan, num_cells, pad)
    _assert_pool_close(got, f, w, plan, num_cells, pad)
    assert torch.equal(got, bev_pool.bev_pool_weighted_rows(f, w, *plan, num_cells, pad))


SORTED_CASES = ["long cell across segments and blocks", "6 ring rows", "100x100 cells", "cells past num_cells"]


def _sorted_case(case):
    """Frustum cells (X, P) and num_cells of a B3 case: 6 rows of 56,000
    points (40 depth bins over 28x50 pixels) on the ring calibration, at
    50x50 or 100x100 cells (empty windows, a ragged last one), or with
    30,000 of each row's points in one cell; or 2 rows of 3,000 points over
    1024 cells pooled into 1000."""
    if case == "cells past num_cells":
        return np.random.RandomState(11).randint(-1, 1024, (2, 3000)).astype(np.int32), 1000
    if case == "long cell across segments and blocks":
        return long_cell_cells(6, 40, 1400, 2500).reshape(6, -1), 2500
    bev = 100 if case == "100x100 cells" else 50
    return ring_camera_cells((448, 800), (bev, bev), 40, 1.0, 60.0, PC_RANGE).reshape(6, -1), bev * bev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_pool_kernel_cases_on_card(cuda_device, dtype, case):
    """B3 on per-point features (C = 256) where one cell spans many warps of
    several blocks, at 6 ring-calibration rows (the grid fills the card's
    SMs), at 100x100 cells and with cells past num_cells: within TOL of the
    terms' magnitudes, two launches equal bit for bit, every real entry
    summed by exactly one warp, and no warp with more than 1.2x its row's
    mean real entries."""
    cells, num_cells = _sorted_case(case)
    plans, pad = _plans(cells, num_cells)
    plan = _on(cuda_device, plans)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    f = torch.randn(cells.shape[0], cells.shape[1], 256, device=cuda_device, generator=g).to(dtype)
    got = bev_pool.bev_pool_rows(f, *plan, num_cells, pad)
    _assert_pool_close(got, f, None, plan, num_cells, pad)
    assert torch.equal(got, bev_pool.bev_pool_rows(f, *plan, num_cells, pad))
    config = bev_pool.sorted_config(f, *plan[0].shape[1:])
    real = bev_pool.sorted_segments(f, *plan, num_cells).cpu()
    assert real.shape == (cells.shape[0], config["warps"])
    lid, bidx = plans["local_ids"], plans["block_idx"]
    entry_cells = np.where(lid >= 0, bidx[..., None] * bev_pool.DEFAULT_WINDOW + lid, -1)
    assert np.array_equal(real.sum(1).numpy(), ((entry_cells >= 0) & (entry_cells < num_cells)).sum((1, 2)))
    if cells.shape[0] == 6:
        assert config["blocks"] >= torch.cuda.get_device_properties(cuda_device).multi_processor_count, config
        share = (real.amax(1).float() / real.float().mean(1)).max().item()
        assert share <= 1.2, f"the busiest warp holds {share:.3f}x its row's mean real entries"


def test_b3_ablation_edits_apply():
    """Every ablated copy of tools/b3_ablation.py is made from the committed
    source's text, and each edit changes it."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.tools import b3_ablation

    sources = b3_ablation._sources([])
    assert set(sources) == {"committed", *b3_ablation.ABLATIONS}
    assert len(set(sources.values())) == len(sources)


def test_b2_ablation_edits_apply():
    """Every ablated copy of tools/b2_ablation.py is made from the committed
    source's text, and each edit changes it."""
    sources = b2_ablation._sources([])
    assert set(sources) == {"committed", *b2_ablation.ABLATIONS}
    assert len(set(sources.values())) == len(sources)


def test_b1_sweep_float64_chain_matches_plain_version():
    """The float64 chain that tools/b1_ablation.py --sweep holds bf16 B1
    against computes the plain version's function: on f32 inputs the two
    agree to f32 rounding, with zero rows in the max as the plain version
    without mask_padding keeps them."""
    from bevfusion_multimodal_3d_object_detection_tpu_torch.tools import b1_ablation

    rng = np.random.RandomState(5)
    ws, bs = _chain(rng, (4, 64, 128, 256))
    x = torch.from_numpy(_points(rng, 3, 100, 4))
    wt, bt = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    got = b1_ablation._float64_chain(x, wt, bt)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got.float(), pointnet_fused_reference(x, wt, bt), atol=1e-5, rtol=1e-5)
