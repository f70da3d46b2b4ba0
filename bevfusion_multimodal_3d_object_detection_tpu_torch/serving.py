"""Batched inference server on one GPU, and its HTTP front end.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/serving.py:41-648``
(without the mesh and AOT options, ROADMAP A13 and A12):

- one forward + decode function over a fixed `batch_size`; partial batches
  are padded and the padding rows dropped on the way out;
- a dispatch thread that coalesces concurrent requests within
  `max_delay_ms`;
- bf16 compute by default (decode in f32), camera BatchNorm folded into the
  convs by default, and the fused PointNet kernel in both point encoders;
- uint8 cameras are normalized on the device; a batch mixing uint8 and
  float cameras normalizes its uint8 rows on the host;
- a two-stage pipeline: batch N+1 is staged and enqueued while batch N's
  small results copy to pinned host memory behind an event;
- per-request futures; `stop()` fails queued requests with
  `ServerStoppedError`;
- `make_http_server`: a stdlib ThreadingHTTPServer around a server
  (``/healthz``, ``/stats``, ``POST /infer`` in npz or JSON).

Weights come from `model_path=` (a msgpack checkpoint of either package;
a failed restore raises), from `variables=` (the JAX model's ``{"params",
"batch_stats"}`` tree as numpy arrays, unfolded) or, with neither, from the
seeded init of `utils.restore.load_serving_variables` (which loads a
pretrained camera trunk where one is configured and present).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import zipfile
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import CompatFlags, DetectorSpec, PostProcessSpec, load_config
from .models.detector import MultiModal3DDetector
from .ops.decode import decode_centernet_predictions, nms_bev
from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_images
from .utils.convert import load_jax_variables
from .utils.device import resolve_device
from .utils.fold_bn import fold_camera_variables
from .utils.restore import load_serving_variables


class ServerStoppedError(RuntimeError):
    """The InferenceServer is stopped or draining: the request was not run
    (retryable), as opposed to an internal error."""


class InferenceServer:
    def __init__(
        self,
        config_path: str = "configs/base.yaml",
        config: Optional[Dict] = None,
        batch_size: int = 8,
        max_delay_ms: float = 5.0,
        score_threshold: float = 0.3,
        use_bf16: bool = True,
        fold_bn: bool = True,
        variables: Optional[Dict] = None,
        device=None,
        model_path: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.config = config if config is not None else load_config(config_path)
        self.spec = DetectorSpec.from_config(self.config)
        if not self.spec.head_is_centernet:
            raise ValueError(
                f"the server decodes CenterNet maps only; fusion_type={self.spec.fusion_type!r} with "
                f"detection_head={self.spec.detection_head!r} builds the MLP head. The JAX server has "
                "only the CenterNet decode as well (serving.py:160) and fails on the first request; "
                "serve such a model through InferenceEngine"
            )
        self.compat = CompatFlags.from_config(self.config)
        self.batch_size = batch_size
        self.max_delay_s = max_delay_ms / 1000.0
        self.score_threshold = score_threshold
        self.fold_bn = fold_bn
        self.post_process = None
        if not self.compat.ignore_post_processing_config:
            self.post_process = PostProcessSpec.from_config(self.config, ("inference", "test"))
            self.score_threshold = self.post_process.score_threshold
        self.dtype = torch.bfloat16 if use_bf16 else torch.float32

        if variables is None:
            variables = load_serving_variables(self.spec, model_path)
        elif model_path is not None:
            raise ValueError("pass model_path or variables, not both")
        model = MultiModal3DDetector(
            self.spec,
            mask_padding=not self.compat.unmasked_point_padding,
            fold_bn=fold_bn,
        )
        if fold_bn:
            variables = fold_camera_variables(variables)
        load_jax_variables(model, variables)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()

        if self.compat.eval_decode_voxel_0512:
            self.voxel_size = 0.512  # Q3
        else:
            x0, y0, _, x1, y1, _ = self.spec.bev.pc_range
            self.voxel_size = ((x1 - x0) / self.spec.bev.bev_w, (y1 - y0) / self.spec.bev.bev_h)

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # fences submit()'s stopped-check + put against stop()'s drain
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0, "total_latency_s": 0.0}

    # -- lifecycle -------------------------------------------------------------
    def start(self, warmup: bool = True) -> "InferenceServer":
        if self._stop.is_set():
            raise ServerStoppedError(
                "InferenceServer cannot be restarted after stop(); construct a new server"
            )
        if warmup:
            # both wire formats: builds the kernel and warms cuDNN before the
            # first request
            self._run_batch([self._zero_sample()] * self.batch_size)
            u8 = self._zero_sample()
            u8["camera_imgs"] = u8["camera_imgs"].astype(np.uint8)
            self._run_batch([u8] * self.batch_size)
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._submit_lock:
            while True:
                try:
                    _, fut, _ = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(ServerStoppedError("InferenceServer stopped"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- API ---------------------------------------------------------------------
    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        """Enqueue one sample; resolves to {boxes (K, 9), scores (K,),
        labels (K,)} above the score threshold. Shapes are checked here."""
        self._validate(sample)
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise ServerStoppedError("InferenceServer stopped")
            self._queue.put((sample, fut, time.perf_counter()))
        return fut

    def infer(self, sample: Dict[str, np.ndarray], timeout: float = 60.0):
        return self.submit(sample).result(timeout=timeout)

    def _validate(self, sample: Dict[str, np.ndarray]) -> None:
        s = self.spec
        h, w = s.camera.image_size
        want = {
            "camera_imgs": (6, h, w, 3),
            "lidar_points": (s.lidar.max_points, s.lidar.input_channels),
            "radar_points": (
                s.radar.num_radars, s.radar.max_points_per_sensor, s.radar.input_channels,
            ),
        }
        for key, shape in want.items():
            if np.shape(sample[key]) != shape:
                raise ValueError(f"{key} must be {shape}, got {np.shape(sample[key])}")

    # -- internals ---------------------------------------------------------------
    def _zero_sample(self) -> Dict[str, np.ndarray]:
        s = self.spec
        h, w = s.camera.image_size
        return {
            "camera_imgs": np.zeros((6, h, w, 3), np.float32),
            "lidar_points": np.zeros((s.lidar.max_points, s.lidar.input_channels), np.float32),
            "radar_points": np.zeros(
                (s.radar.num_radars, s.radar.max_points_per_sensor, s.radar.input_channels),
                np.float32,
            ),
        }

    def _collect(self, poll_s: float = 0.05) -> Optional[list]:
        """Block for the first request, then coalesce up to batch_size
        within max_delay. None when idle."""
        try:
            first = self._queue.get(timeout=poll_s)
        except queue.Empty:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_delay_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _dispatch(self) -> None:
        """Launch batch N+1 before resolving batch N, so staging and the
        device work of one batch overlap the other's result copy."""
        pending = None  # (launched, futures, n, t_enqs)
        while not self._stop.is_set():
            batch = self._collect(poll_s=0.002 if pending else 0.05)
            if batch is None:
                if pending is not None:
                    self._finish(*pending)
                    pending = None
                continue
            # RUNNING: drops client-cancelled futures, and cancel() can no
            # longer race set_result
            batch = [b for b in batch if b[1].set_running_or_notify_cancel()]
            if not batch:
                continue
            futures = [b[1] for b in batch]
            try:
                launched = self._launch([b[0] for b in batch])
            except Exception as e:  # surface server errors to callers
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            if pending is not None:
                self._finish(*pending)
            pending = (launched, futures, len(batch), [b[2] for b in batch])
        if pending is not None:
            self._finish(*pending)

    @torch.inference_mode()
    def _serve(self, cams: torch.Tensor, lidar: torch.Tensor, radars: torch.Tensor):
        s = self.spec
        if cams.dtype == torch.uint8:
            cams = normalize_images(cams, size=s.camera.image_size)
        preds = self.model(
            cams.to(self.dtype) if s.use_camera else None,
            lidar if s.use_lidar else None,
            radars if s.use_radar else None,
        )
        return decode_centernet_predictions(
            preds,
            max_detections=s.centernet.max_detections,
            voxel_size=self.voxel_size,
            pc_range=s.bev.pc_range,
            class_always_zero=self.compat.decode_class_always_zero,
        )

    def _launch(self, samples: List[Dict]):
        """Stage and enqueue one batch; returns (host outputs, event) without
        waiting for the device."""
        n = len(samples)
        if len({np.asarray(s["camera_imgs"]).dtype for s in samples}) > 1:
            # np.stack would promote uint8 rows to float without normalizing
            samples = [
                dict(
                    s,
                    camera_imgs=(np.asarray(s["camera_imgs"], np.float32) / 255.0 - IMAGENET_MEAN)
                    / IMAGENET_STD,
                )
                if np.asarray(s["camera_imgs"]).dtype == np.uint8
                else s
                for s in samples
            ]
        pad_sample = {k: np.zeros_like(v) for k, v in samples[0].items()}
        padded = samples + [pad_sample] * (self.batch_size - n)

        def stage(key):
            host = torch.from_numpy(np.ascontiguousarray(np.stack([s[key] for s in padded])))
            return host.to(self.device)

        cams = stage("camera_imgs")
        if cams.dtype != torch.uint8:
            cams = cams.to(self.dtype)
        out = self._serve(
            cams, stage("lidar_points").to(self.dtype), stage("radar_points").to(self.dtype)
        )
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    def _finish(self, launched, futures, n: int, t_enqs: List[float]) -> None:
        try:
            results = self._fetch(launched, n)
        except Exception as e:
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
            return
        for fut, res in zip(futures, results):
            if not fut.done():
                fut.set_result(res)
        now = time.perf_counter()
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["padded_rows"] += self.batch_size - n
        self.stats["total_latency_s"] += sum(now - t for t in t_enqs)

    def _fetch(self, launched, n: int) -> List[Dict]:
        host, event = launched
        if event is not None:
            event.synchronize()
        # boxes ship as (K, 9) = [x y z w l h yaw vx vy]
        boxes = np.concatenate(
            [host["boxes"].float().numpy(), host["velocities"].float().numpy()], axis=-1
        )
        scores = host["scores"].float().numpy()
        labels = host["labels"].numpy().astype(np.int64)
        results = []
        for i in range(n):
            keep = scores[i] > self.score_threshold
            res = {"boxes": boxes[i][keep], "scores": scores[i][keep], "labels": labels[i][keep]}
            if self.post_process is not None:
                res = nms_bev(res, self.post_process.nms_threshold)
                cap = self.post_process.max_detections
                if len(res["scores"]) > cap:
                    res = {k: v[:cap] for k, v in res.items()}
            results.append(res)
        return results

    def _run_batch(self, samples: List[Dict]) -> List[Dict]:
        """Synchronous path (warmup, tests, timing): launch + fetch."""
        return self._fetch(self._launch(samples), len(samples))


# ---------------------------------------------------------------------------
# HTTP front end (stdlib http.server)
# ---------------------------------------------------------------------------


def _parse_sample(raw: bytes, ctype: str) -> Dict[str, np.ndarray]:
    """One request body -> sample dict. uint8 arrays of the npz wire stay
    uint8 (normalized on the device); everything else becomes float32."""
    if "npz" in ctype:
        with np.load(io.BytesIO(raw)) as z:
            arrays = {k: z[k] for k in z}
        return {k: v if v.dtype == np.uint8 else v.astype(np.float32, copy=False) for k, v in arrays.items()}
    return {k: np.asarray(v, np.float32) for k, v in json.loads(raw).items()}


def make_http_server(server: InferenceServer, host: str, port: int,
                     max_request_bytes: int = 64 * 1024 * 1024):
    """A ThreadingHTTPServer around `server` (started by the caller); port 0
    binds a free port (``httpd.server_address[1]``).

      GET  /healthz -> {"status": "ok"}
      GET  /stats   -> the server's request/batch/latency counters, the
                       uptime and the mean request latency
      POST /infer   -> one sample as application/x-npz (np.savez of
                       camera_imgs, lidar_points, radar_points) or
                       application/json (the same keys as nested lists);
                       answers {"boxes": (K, 9) [x y z w l h yaw vx vy],
                       "scores": (K,), "labels": (K,)} as JSON lists.

    A Content-Length above `max_request_bytes` (64 MiB by default, ~10x a
    uint8 tri-modal sample) gets 413 without the body being read. A body
    that does not parse or does not fit the model's shapes gets 400; a
    fault while the request runs gets 500, a stopped or draining server
    503 and a request that timed out 504 (it was accepted, so the client
    does not retry it). Concurrent requests coalesce into device batches
    through the server's dispatch thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    t_start = time.time()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                st = dict(server.stats)
                st["uptime_s"] = time.time() - t_start
                if st["requests"]:
                    st["mean_latency_s"] = st["total_latency_s"] / st["requests"]
                self._reply(200, st)
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/infer":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0:  # a negative length would read until the client closes
                self._reply(400, {"error": "bad Content-Length"})
                return
            if n > max_request_bytes:
                self._reply(413, {"error": f"request too large: {n} > {max_request_bytes} bytes"})
                return
            raw = self.rfile.read(n)
            try:
                sample = _parse_sample(raw, self.headers.get("Content-Type", "application/json"))
                fut = server.submit(sample)  # checks the keys and shapes
            except ServerStoppedError:
                self._reply(503, {"error": "server unavailable"})
                return
            except (ValueError, KeyError, TypeError, AttributeError, zipfile.BadZipFile, OSError) as e:
                # a client fault: the body does not parse or does not fit
                # the model (JSONDecodeError is a ValueError)
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                res = fut.result(timeout=120.0)
            except TimeoutError:
                self._reply(504, {"error": "inference timed out"})
                return
            except ServerStoppedError:
                self._reply(503, {"error": "server unavailable"})
                return
            except Exception:
                # a fault inside the server, whatever its type: no internals
                # leak to the client
                self._reply(500, {"error": "internal error"})
                return
            self._reply(200, {"boxes": res["boxes"].tolist(), "scores": res["scores"].tolist(),
                              "labels": res["labels"].tolist()})

    class Server(ThreadingHTTPServer):
        # the listen backlog: socketserver's 5 drops the connections of a
        # burst of concurrent clients, whose kernels retry them after ~1 s
        request_queue_size = 128

    return Server((host, port), Handler)
