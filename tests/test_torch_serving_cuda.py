"""The server's staging ring on a card: its slots are page-locked, batches
launched back to back (each staged while earlier copies may still be in
flight) serve what the synchronous path serves, bit for bit, and two
replicas on one card stage through the same ring and serve what one
replica serves at their part's rows.

This file imports neither jax, flax nor the JAX package; on a machine with
a card, ``python -m pytest tests/test_torch_serving_cuda.py -m cuda`` runs
it. The `cuda`-marked tests skip without a card."""

import pathlib

import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu_torch.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
from chip_smoke import make_samples


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _narrow_config():
    cfg = load_config(str(pathlib.Path(__file__).resolve().parents[1] / "configs" / "base.yaml"))
    m = cfg["model"]
    m["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    m["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    m["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    m["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    m["centernet_head"].update(in_channels=32, head_conv=16)
    return cfg


def _uint8_samples(spec, n, seed):
    """`n` samples on the uint8 wire."""
    samples = make_samples(spec, np.random.RandomState(seed), 2 * n)
    return [s for s in samples if s["camera_imgs"].dtype == np.uint8]


def _assert_bit_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert np.array_equal(g[k], w[k]), f"{what}: request {i}, {k}"


@pytest.mark.cuda
def test_back_to_back_launches_serve_what_run_batch_serves(cuda_device):
    """Four batches through `_launch` before any `_fetch`, behind a stream
    held busy, so that the third and fourth batches find their slots' copies
    still queued: the event guard holds them until those copies ran."""
    server = InferenceServer(config=_narrow_config(), batch_size=2, score_threshold=0.0, device=cuda_device)
    batches = [_uint8_samples(server.spec, 2, seed) for seed in range(4)]
    want = [server._run_batch(b) for b in batches]
    assert server.stats["slot_allocs"] == 2
    host = server._host_batch(batches[0])
    assert all(t.is_pinned() for t in host)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream before the first copy
    launched = [server._launch(b) for b in batches]
    assert all(pinned for _, _, pinned in launched)
    got = [server._fetch(parts, len(b)) for (_, parts, _), b in zip(launched, batches)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bit_equal(g, w, f"batch {i}")
    assert server.stats["slot_allocs"] == 2


@pytest.mark.cuda
def test_two_replicas_stage_through_the_ring(cuda_device):
    """Two replicas on one card at batch 4 (parts of 2 rows) against one
    replica at batch 2 on each part: the same shapes, so the same bits."""
    cfg = _narrow_config()
    kw = dict(config=cfg, score_threshold=0.0)
    one = InferenceServer(batch_size=2, device=cuda_device, **kw)
    two = InferenceServer(batch_size=4, devices=[cuda_device, cuda_device], **kw)
    batches = [_uint8_samples(one.spec, 4, seed) for seed in (5, 6, 7)]
    want = [one._run_batch(b[:2]) + one._run_batch(b[2:]) for b in batches]
    launched = [two._launch(b) for b in batches]
    got = [two._fetch(parts, len(b)) for (_, parts, _), b in zip(launched, batches)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bit_equal(g, w, f"batch {i}")
    assert all(pinned for _, _, pinned in launched) and two.stats["slot_allocs"] == 2
