"""The port's HTTP front end (`serving.make_http_server`), client and serve
CLI on the CPU, mirroring the mesh-free cases of tests/test_serving.py:
routes, both wire formats, 413 without reading the body, 400 for a body
that does not parse or fit against 500 for a fault inside the server and
503 for a stopped one, the client's round trip and retry rules,
`encode_npz`'s key stripping, and the drain, in process and through the
CLI's SIGTERM. Wire results equal the in-process `server.infer` of the same
sample (npz: exactly, JSON: 1e-5, the lists' float round trip)."""

import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import unittest.mock as mock
import urllib.error
import urllib.request
from http.client import HTTPConnection

import numpy as np
import pytest
import yaml

from bevfusion_multimodal_3d_object_detection_tpu_torch import client as cmod
from bevfusion_multimodal_3d_object_detection_tpu_torch.client import ClientError, InferenceClient, encode_npz
from bevfusion_multimodal_3d_object_detection_tpu_torch.config import load_config
from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer, make_http_server

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def narrow_config():
    cfg = load_config(str(ROOT / "configs" / "base.yaml"))
    model = cfg["model"]
    model["modality_config"] = "camera+radar"
    model["camera_encoder"]["input_size"] = [32, 64]
    cfg["dataset"]["max_points"] = {"lidar": 256, "radar_per_sensor": 16}
    model["radar_encoder"].update(mlp_layers=[8, 16, 32], feature_dim=32)
    model["bev_fusion"].update(bev_h=16, bev_w=16, bev_channels=32)
    model["centernet_head"].update(in_channels=32, head_conv=16)
    return cfg


def _sample(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "camera_imgs": rng.randint(0, 256, (6, 32, 64, 3)).astype(np.uint8),
        "lidar_points": rng.randn(256, 4).astype(np.float32),
        "radar_points": rng.randn(5, 16, 7).astype(np.float32),
    }


class _Http:
    """A started server behind an HTTP front end on a free port."""

    def __init__(self, config, max_request_bytes=64 * 1024 * 1024, **kw):
        kw = {"batch_size": 2, "max_delay_ms": 1.0, "use_bf16": False, "fold_bn": False,
              "score_threshold": 0.0, **kw}
        self.server = InferenceServer(config=config, device="cpu", **kw).start()
        self.httpd = make_http_server(self.server, "127.0.0.1", 0, max_request_bytes=max_request_bytes)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.stop()


@pytest.fixture
def http(narrow_config):
    h = _Http(narrow_config)
    try:
        yield h
    finally:
        h.close()


def _post(url, data, ctype):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def _status(url, data=None, ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if data is not None else {})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    return exc.value.code, json.load(exc.value)["error"]


def test_routes_and_wire_formats(http):
    with urllib.request.urlopen(f"{http.base}/healthz", timeout=30) as r:
        assert json.load(r) == {"status": "ok"}
    sample = _sample()
    direct = http.server.infer(sample, timeout=60)
    buf = io.BytesIO()
    np.savez(buf, **sample)
    out = _post(f"{http.base}/infer", buf.getvalue(), "application/x-npz")
    assert np.array_equal(np.asarray(out["boxes"], np.float32), direct["boxes"])
    assert np.array_equal(np.asarray(out["scores"], np.float32), direct["scores"])
    assert out["labels"] == direct["labels"].tolist() and len(out["boxes"][0]) == 9
    # JSON lists: the uint8 cameras arrive as floats in 0..255
    float_sample = dict(sample, camera_imgs=sample["camera_imgs"].astype(np.float32))
    out2 = _post(f"{http.base}/infer", json.dumps({k: v.tolist() for k, v in float_sample.items()}).encode(),
                 "application/json")
    want = http.server.infer(float_sample, timeout=60)
    np.testing.assert_allclose(out2["scores"], want["scores"], rtol=0, atol=1e-5)
    with urllib.request.urlopen(f"{http.base}/stats", timeout=30) as r:
        stats = json.load(r)
    assert stats["requests"] == 4 and stats["uptime_s"] > 0 and stats["mean_latency_s"] > 0
    assert _status(f"{http.base}/nowhere")[0] == 404
    assert _status(f"{http.base}/infer/x", b"{}")[0] == 404


def test_oversized_request_413(narrow_config):
    h = _Http(narrow_config, max_request_bytes=1024)
    try:
        code, msg = _status(f"{h.base}/infer", b"x" * 2048)
        assert code == 413 and "too large" in msg
        assert h.server.stats["requests"] == 0
    finally:
        h.close()


def test_client_faults_400_server_faults_500_and_503(narrow_config):
    h = _Http(narrow_config)
    try:
        bad_shape = dict(_sample(), camera_imgs=np.zeros((6, 8, 64, 3), np.uint8))
        buf = io.BytesIO()
        np.savez(buf, **bad_shape)
        for body, ctype in ((b"not-a-sample", "application/json"), (b"[1, 2]", "application/json"),
                            (b"PK\x03\x04garbage-not-a-zip", "application/x-npz"),
                            (json.dumps({"camera_imgs": [1.0]}).encode(), "application/json"),
                            (buf.getvalue(), "application/x-npz")):
            assert _status(f"{h.base}/infer", body, ctype)[0] == 400, body[:20]
        for length in ("-1", "x"):  # answered without reading a body
            conn = HTTPConnection("127.0.0.1", h.httpd.server_address[1], timeout=30)
            conn.putrequest("POST", "/infer")
            conn.putheader("Content-Length", length)
            conn.endheaders()
            assert conn.getresponse().status == 400, length
            conn.close()
        # a fault inside the server is 500 whatever its type, with no internals
        good = io.BytesIO()
        np.savez(good, **_sample())
        for exc in (ValueError("bad value inside"), RuntimeError("device error")):
            with mock.patch.object(h.server, "_serve", side_effect=exc):
                assert _status(f"{h.base}/infer", good.getvalue(), "application/x-npz") == (500, "internal error")
        h.server.stop()  # stopped backend, front end still up
        assert _status(f"{h.base}/infer", good.getvalue(), "application/x-npz") == (503, "server unavailable")
    finally:
        h.close()


def test_client_roundtrip_and_errors(http):
    client = InferenceClient(http.base, retries=1)
    client.wait_ready(timeout_s=30)
    sample = dict(_sample(1), token="s1", gt_boxes=np.zeros((3, 7)))  # a dataset sample as it is
    out = client.infer(sample)
    direct = http.server.infer({k: sample[k] for k in cmod.WIRE_KEYS}, timeout=60)
    assert np.array_equal(out["boxes"], direct["boxes"]) and np.array_equal(out["scores"], direct["scores"])
    assert client.stats()["requests"] == 2
    with pytest.raises(ClientError) as exc:
        client._request("/infer", data=b"junk", content_type="application/json")
    assert exc.value.status == 400
    port = http.httpd.server_address[1]
    http.close()
    dead = InferenceClient(f"http://127.0.0.1:{port}", retries=1, backoff_s=0.05, timeout_s=2)
    assert not dead.healthz()
    with pytest.raises(OSError):
        dead.infer(_sample())


def test_client_retry_semantics(monkeypatch):
    """POSTs retry only failures before the connection (refused, DNS); a
    reset or a broken pipe may come after the server accepted the request.
    GETs retry any transport failure; 503 is retried, 500 not."""
    calls = {"n": 0}

    def failing(exc):
        def _open(req, timeout=None):
            calls["n"] += 1
            raise exc
        return _open

    c = InferenceClient("http://127.0.0.1:1", retries=2, backoff_s=0.0, timeout_s=1)
    cases = [
        ("/infer", b"x", urllib.error.URLError(ConnectionResetError("reset")), urllib.error.URLError, 1),
        ("/infer", b"x", BrokenPipeError("pipe"), OSError, 1),
        ("/infer", b"x", TimeoutError("slow"), TimeoutError, 1),
        ("/infer", b"x", urllib.error.URLError(ConnectionRefusedError("refused")), urllib.error.URLError, 3),
        ("/stats", None, urllib.error.URLError(ConnectionResetError("reset")), urllib.error.URLError, 3),
        ("/infer", b"x", urllib.error.HTTPError("u", 503, "down", {}, io.BytesIO(b'{"error": "x"}')),
         cmod.ServerError, 3),
        ("/infer", b"x", urllib.error.HTTPError("u", 500, "bad", {}, io.BytesIO(b'{"error": "x"}')),
         cmod.ServerError, 1),
    ]
    for path, data, exc, raised, attempts in cases:
        calls["n"] = 0
        monkeypatch.setattr(cmod.urllib.request, "urlopen", failing(exc))
        with pytest.raises(raised):
            c._request(path, data=data)
        assert calls["n"] == attempts, (path, exc)


def test_encode_npz_strips_non_wire_keys():
    sample = {
        "camera_imgs": np.zeros((6, 4, 4, 3), np.uint8),
        "lidar_points": np.zeros((16, 4), np.float64),
        "token": "synthetic_0",
        "gt_boxes": np.zeros((3, 7), np.float32),
        "camera_seg_idx": np.zeros((6, 8), np.int32),
    }
    with np.load(io.BytesIO(encode_npz(sample))) as z:
        assert set(z.files) == {"camera_imgs", "lidar_points"}
        assert z["camera_imgs"].dtype == np.uint8 and z["lidar_points"].dtype == np.float32
    with pytest.raises(ValueError, match="wire keys"):
        encode_npz({"token": "x"})


def test_drain_completes_inflight(narrow_config):
    """Non-daemon handler threads and block_on_close (as the serve CLI sets
    them): a request in the coalescing window when shutdown begins still
    gets its answer."""
    h = _Http(narrow_config, max_delay_ms=300.0)
    h.httpd.daemon_threads = False
    h.httpd.block_on_close = True
    result = {}

    def send():
        result.update(_post(f"{h.base}/infer", encode_npz(_sample()), "application/x-npz"))

    t = threading.Thread(target=send)
    t.start()
    time.sleep(0.1)  # the request now waits in the coalescing window
    h.close()
    t.join(timeout=60)
    assert not t.is_alive() and len(result["scores"]) == 100


def test_serve_cli_drains_on_sigterm(narrow_config, tmp_path):
    """`python -m ...serve --device cpu --port 0`: one request answered,
    then SIGTERM with a second in flight; both answered, exit 0."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(narrow_config))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "bevfusion_multimodal_3d_object_detection_tpu_torch.serve", "--config", str(cfg),
         "--device", "cpu", "--port", "0", "--batch-size", "2", "--max-delay-ms", "500", "--f32",
         "--score-threshold", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path),
    )
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("Serving on "):
                break
        base = lines[-1].split()[2]
        client = InferenceClient(base, retries=0)
        first = client.infer(_sample(2))
        result = {}
        t = threading.Thread(target=lambda: result.update(client.infer(_sample(3))))
        t.start()
        time.sleep(0.2)  # in the 500 ms coalescing window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=60)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + proc.stdout.read()
    assert rc == 0, out
    assert len(first["scores"]) == len(result["scores"]) == 100
    assert "draining" in out and "Drained" in out
