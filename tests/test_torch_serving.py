"""The PyTorch port's InferenceServer (on the CPU) against the JAX
InferenceServer, both serving the same seeded weights in f32 with camera
BatchNorm folded: a uint8 request, float requests and a partial batch give
the same detections (scores 1e-4, boxes 1e-3 absolute)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevfusion_multimodal_3d_object_detection_tpu.config import DetectorSpec, load_config
from bevfusion_multimodal_3d_object_detection_tpu.models import MultiModal3DDetector
from bevfusion_multimodal_3d_object_detection_tpu.serving import (
    InferenceServer as JaxServer,
)
from bevfusion_multimodal_3d_object_detection_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import (
    InferenceServer,
    ServerStoppedError,
    _Slot,
)
from torch_port_helpers import detector_inputs, random_variables


@pytest.fixture(scope="module")
def narrow_config():
    cfg = load_config(str(pathlib.Path(__file__).parents[1] / "configs" / "base.yaml"))
    model = cfg["model"]
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["lidar_encoder"]["mlp_layers"] = [16, 32, 64]
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    return cfg


@pytest.fixture(scope="module")
def variables(narrow_config):
    spec = DetectorSpec.from_config(narrow_config)
    args = tuple(jnp.asarray(a[:1]) for a in detector_inputs(spec))
    init = MultiModal3DDetector(spec=spec).init({"params": jax.random.PRNGKey(0)}, *args)
    return random_variables(init, seed=11)


def _samples(spec, n, seed):
    cams, lidar, radar = detector_inputs(spec, batch=n, seed=seed)
    return [
        {"camera_imgs": cams[i], "lidar_points": lidar[i], "radar_points": radar[i]}
        for i in range(n)
    ]


def _sorted(res):
    order = np.lexsort((res["scores"], res["boxes"][:, 1], res["boxes"][:, 0]))
    return {k: v[order] for k, v in res.items()}


def test_server_matches_jax_server(narrow_config, variables):
    kw = dict(config=narrow_config, batch_size=2, max_delay_ms=200.0, score_threshold=0.5,
              use_bf16=False, fold_bn=True, variables=variables)
    samples = _samples(DetectorSpec.from_config(narrow_config), 3, seed=5)
    rng = np.random.RandomState(6)
    samples[0]["camera_imgs"] = rng.randint(0, 256, (6, 32, 64, 3), np.uint8)
    with JaxServer(**kw) as jax_server:
        want = [jax_server.infer(s, timeout=300) for s in samples]
    port = InferenceServer(device="cpu", **kw)
    with port:
        # three requests on batch 2: a coalesced batch (mixed wires) and a
        # partial one
        futures = [port.submit(s) for s in samples]
        got = [f.result(timeout=300) for f in futures]
    assert port.stats["requests"] == 3 and port.stats["padded_rows"] >= 1
    n_dets = 0
    for g, w in zip(got, want):
        assert g["boxes"].shape[1] == 9
        assert len(g["scores"]) == len(w["scores"])
        g, w = _sorted(g), _sorted(w)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        n_dets += len(g["scores"])
    assert n_dets > 0  # the comparison saw detections


def test_server_contract(narrow_config):
    """Shape check at submit, cancelled futures skipped, and stop() failing
    queued requests; a stopped server does not restart."""
    server = InferenceServer(config=narrow_config, batch_size=2, max_delay_ms=1.0,
                             use_bf16=True, device="cpu", score_threshold=0.0)
    sample = _samples(server.spec, 1, seed=7)[0]
    bad = dict(sample, camera_imgs=sample["camera_imgs"][:, :8])
    with pytest.raises(ValueError, match="camera_imgs"):
        server.submit(bad)
    cancelled = server.submit(sample)
    assert cancelled.cancel()
    with server:
        res = server.infer(sample, timeout=120)
    assert res["boxes"].shape == (100, 9) and np.isfinite(res["boxes"]).all()
    with pytest.raises(ServerStoppedError):
        server.submit(sample)
    with pytest.raises(ServerStoppedError, match="restarted"):
        server.start(warmup=False)

    idle = InferenceServer(config=narrow_config, batch_size=2, use_bf16=False, device="cpu")
    fut = idle.submit(sample)  # never started: stays queued
    idle.stop()
    with pytest.raises(ServerStoppedError):
        fut.result(timeout=5)


def test_bf16_server_matches_jax_fused_server(narrow_config, variables):
    """ROADMAP C2. The port's bf16 server always runs the fused PointNet
    (its plain version on the CPU); JAX's does with use_pallas=True (the
    Pallas kernel in interpret mode on the CPU). Per sample, the sorted
    scores of the 100 detections agree within 3e-2 absolute (scores up to
    ~0.68): the spread of bf16 itself, since JAX's bf16 servers differ from
    its f32 server by up to 4.1e-2 here. Found: 1.8e-2 to JAX's fused
    server and 1.8e-2 to its default (use_pallas=False) one; the two JAX
    bf16 servers differ by 1.4e-2."""
    kw = dict(config=narrow_config, batch_size=2, score_threshold=0.0, use_bf16=True,
              fold_bn=True, variables=variables)
    samples = _samples(DetectorSpec.from_config(narrow_config), 2, seed=5)
    want = JaxServer(use_pallas=True, **kw)._run_batch(samples)
    got = InferenceServer(device="cpu", **kw)._run_batch(samples)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"]) == 100
        np.testing.assert_allclose(np.sort(g["scores"]), np.sort(w["scores"]), rtol=0, atol=3e-2)
        assert np.isfinite(g["boxes"]).all()


def _plain_stack(samples, batch_size):
    """The staging before the ring: a uint8 row of a mixed batch normalized
    on the host, zero padding rows, one fresh np.stack a wire key."""
    if len({s["camera_imgs"].dtype for s in samples}) > 1:
        samples = [dict(s, camera_imgs=(s["camera_imgs"].astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
                   if s["camera_imgs"].dtype == np.uint8 else s for s in samples]
    pad = {k: np.zeros_like(v) for k, v in samples[0].items()}
    padded = samples + [pad] * (batch_size - len(samples))
    return [np.stack([s[k] for s in padded]) for k in ("camera_imgs", "lidar_points", "radar_points")]


def test_staging_ring_reuses_its_slots_bit_for_bit(narrow_config):
    """Each batch through `_host_batch` equals a plain np.stack of its
    samples bit for bit: a full uint8 batch, a full float32 one, a mixed one
    (staged through the float32 ring), then a partial uint8 batch in the
    slot the first full one used, whose stale rows read zero. A signature's
    third batch reuses its first slot's memory, nothing is allocated after
    the first batch of each signature, and a CPU server pins nothing. The
    served detections are those of the plain stack."""
    server = InferenceServer(config=narrow_config, batch_size=3, use_bf16=False, device="cpu",
                             score_threshold=0.0)
    floats = _samples(server.spec, 3, seed=8)
    rng = np.random.RandomState(9)
    u8 = [dict(s, camera_imgs=rng.randint(0, 256, s["camera_imgs"].shape, np.uint8)) for s in floats]
    batches = [("uint8", u8), ("float32", floats), ("mixed", [u8[0], floats[1], u8[2]]),
               ("uint8 again", u8[::-1]), ("partial uint8", u8[1:2])]
    ptrs = []
    for name, batch in batches:
        host = server._host_batch(batch)
        for got, want in zip(host, _plain_stack(batch, server.batch_size)):
            assert got.dtype == torch.from_numpy(want).dtype and not got.is_pinned(), name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        ptrs.append(host[0].data_ptr())
        assert server.stats["slot_allocs"] == (2 if name == "uint8" else 4), name
    assert ptrs[4] == ptrs[0] and len({ptrs[0], ptrs[1], ptrs[2], ptrs[3]}) == 4
    assert not host[0][1:].any() and not host[1][1:].any()  # the full batch's rows, zeroed

    plain = [torch.from_numpy(a) for a in _plain_stack(u8[1:2], server.batch_size)]
    staged = server._to_device(_Slot(plain), server.device, slice(None))
    want = server._fetch([server._enqueue_outputs(server._serve(*staged), server.device)], 1)
    got = server._run_batch(u8[1:2])
    assert server.stats["slot_allocs"] == 4 and len(got[0]["scores"]) > 0
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[0][key], want[0][key])
