"""Python client of the serving HTTP API (`serving.make_http_server`,
``python -m bevfusion_multimodal_3d_object_detection_tpu_torch.serve``).

The port's own copy of
``bevfusion_multimodal_3d_object_detection_tpu/client.py:33-187``, stdlib
only (urllib): the npz wire (uint8 cameras pass through), bounded retries
with exponential backoff on failures where the server provably did not run
the request (connection refused, DNS, 503), and none on client errors
(4xx), 500, 504 or a POST that may have been accepted.

    client = InferenceClient("http://127.0.0.1:8080")
    det = client.infer({"camera_imgs": imgs, "lidar_points": pts, "radar_points": radar})
    det["boxes"], det["scores"], det["labels"]
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

import numpy as np


class ServerError(RuntimeError):
    """5xx from the server (503 is retried up to the configured budget)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ClientError(ValueError):
    """4xx from the server: the request itself is wrong; never retried."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


# the serving wire contract (InferenceServer._validate): anything else a
# dataset sample carries (token, gt_* arrays, plans) is not model input
WIRE_KEYS = ("camera_imgs", "lidar_points", "radar_points")


def encode_npz(sample: Dict[str, np.ndarray]) -> bytes:
    """np.savez of the sample's model-input keys: uint8 arrays stay uint8,
    everything else becomes float32, and other keys are dropped, so
    `client.infer(dataset[i])` works as it is."""
    wire = {k: sample[k] for k in WIRE_KEYS if k in sample}
    if not wire:
        raise ValueError(f"sample has none of the wire keys {WIRE_KEYS}; got {sorted(sample)}")
    buf = io.BytesIO()
    np.savez(buf, **{
        k: np.asarray(v) if np.asarray(v).dtype == np.uint8 else np.asarray(v, np.float32)
        for k, v in wire.items()
    })
    return buf.getvalue()


class InferenceClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8080", timeout_s: float = 120.0,
                 retries: int = 3, backoff_s: float = 0.5):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_s = backoff_s

    def _request(self, path: str, data: Optional[bytes] = None,
                 content_type: str = "application/x-npz", retryable: bool = True) -> Dict:
        last: Exception = RuntimeError("no attempt")
        attempts = self.retries + 1 if retryable else 1
        for attempt in range(attempts):
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            req = urllib.request.Request(
                self.base_url + path, data=data,
                headers={"Content-Type": content_type} if data is not None else {},
                method="POST" if data is not None else "GET",
            )
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                body = e.read().decode(errors="replace")
                try:
                    msg = json.loads(body).get("error", body)
                except json.JSONDecodeError:
                    msg = body
                if 400 <= e.code < 500:
                    raise ClientError(e.code, msg) from None
                last = ServerError(e.code, msg)
                # 503 = unavailable (drain or stop): safe to retry. 504 (the
                # request was accepted and timed out) and 500 (a fault of
                # unknown extent) may duplicate device work
                if e.code != 503:
                    raise last from None
            except TimeoutError as e:
                # a POST may have been accepted and still be running: only
                # GETs retry
                if data is not None:
                    raise
                last = e
            except (urllib.error.URLError, OSError) as e:
                if data is not None:
                    # POST: retry only failures before the connection
                    # (refused, DNS), where the server never saw the request;
                    # a reset or broken pipe may come after it was accepted
                    cause = getattr(e, "reason", e)
                    if not isinstance(cause, (ConnectionRefusedError, socket.gaierror)):
                        raise
                last = e
        raise last

    def infer(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """One sample -> {"boxes": (K, 9) f32, "scores": (K,) f32,
        "labels": (K,) i32}."""
        out = self._request("/infer", data=encode_npz(sample))
        return {
            "boxes": np.asarray(out["boxes"], np.float32).reshape(-1, 9),
            "scores": np.asarray(out["scores"], np.float32),
            "labels": np.asarray(out["labels"], np.int32),
        }

    def healthz(self) -> bool:
        try:
            return self._request("/healthz").get("status") == "ok"
        except (ServerError, ClientError, OSError, ValueError, http.client.HTTPException):
            return False

    def wait_ready(self, timeout_s: float = 300.0, poll_s: float = 1.0) -> None:
        """Block until /healthz answers (the server warms up its kernels
        and the model before it listens)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.healthz():
                return
            time.sleep(poll_s)
        raise TimeoutError(f"server not ready after {timeout_s:.0f}s")

    def stats(self) -> Dict:
        return self._request("/stats")
