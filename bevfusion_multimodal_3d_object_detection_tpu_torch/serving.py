"""Batched inference server on one GPU or several, and its HTTP front end.

Port of ``bevfusion_multimodal_3d_object_detection_tpu/serving.py:41-648``:

- one forward + decode function over a fixed `batch_size`; partial batches
  are padded and the padding rows dropped on the way out;
- a dispatch thread that coalesces concurrent requests within
  `max_delay_ms`;
- bf16 compute by default (decode in f32), camera BatchNorm folded into the
  convs by default, and the fused PointNet kernel in both point encoders;
- uint8 cameras are normalized on the device; a batch mixing uint8 and
  float cameras normalizes its uint8 rows on the host;
- a staging ring: each batch signature (the wire keys' dtypes and
  full-batch shapes: the uint8 and the float32 wire) has two host buffers,
  allocated on its first use (page-locked on a CUDA server) and reused in
  turn; a batch's samples are stacked straight into the next one, its
  padding rows zeroed, and copied to the device asynchronously, each
  replica's rows on its stream. A buffer is written again only once the
  events recorded behind the copies that last read it have completed;
- a two-stage pipeline: batch N+1 is staged and enqueued while batch N's
  small results copy to pinned host memory behind an event;
- per-request futures; `stop()` fails queued requests with
  `ServerStoppedError`;
- `stats`: requests, batches, the batches staged in page-locked memory,
  padded rows, the summed submit-to-result latency, the summed queue wait
  (submit to the start of the batch's staging) and the staging buffers
  allocated, always on;
- spans (`utils.profiling.span`, recorded only while a profiler runs), each
  with the per-server `batch` number: ``serve.stage`` (stacking and padding
  the batch, its host-to-device copies; with ``requests``, ``queue_wait_s``,
  ``h2d_bytes`` and ``pinned``, 1 for a batch staged in page-locked
  memory), ``serve.launch`` (forward, decode and the outputs' copies
  enqueued) and ``serve.fetch`` (the wait for the outputs and the host
  post-processing). Batch N's fetch overlaps batch N+1's stage, so neither
  is the other's parent;
- `aot_path=`: serve from an artifact of `utils.aot.export_serving_artifact`
  (one `torch.export` program per wire signature) with this server's own
  weights, in place of the live model code;
- `devices=[...]` (the JAX server's mesh, ``:54-125, 400-460``): one
  replica of the model per entry, its weights placed once, each on its own
  CUDA stream; a coalesced batch is cut into equal contiguous parts, the
  parts launched back to back, one a replica, and their results gathered in
  order. A device may repeat (two replicas on one card). A 2-D grid
  (rows: replicas; columns: the view axis, ``:67-77``) splits the cameras
  of a row's part over the row's devices, a trunk replica each, and
  gathers the features on the row's first device (`parallel.LocalViews`);
- `make_http_server`: a stdlib ThreadingHTTPServer around a server
  (``/healthz``, ``/stats``, ``POST /infer`` in npz or JSON).

Weights come from `model_path=` (a msgpack checkpoint of either package;
a failed restore raises), from `variables=` (the JAX model's ``{"params",
"batch_stats"}`` tree as numpy arrays, unfolded) or, with neither, from the
seeded init of `utils.restore.load_serving_variables` (which loads a
pretrained camera trunk where one is configured and present).
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import queue
import threading
import time
import zipfile
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import CompatFlags, DetectorSpec, PostProcessSpec, load_config
from .data.dataset import normalize_host_images
from .models.detector import MultiModal3DDetector
from .ops.decode import centernet_decoder, filter_detections
from .parallel.view import LocalViews
from .utils.convert import load_jax_variables
from .utils.device import resolve_device
from .utils.fold_bn import fold_camera_variables
from .utils.profiling import span
from .utils.restore import load_serving_variables


class ServerStoppedError(RuntimeError):
    """The InferenceServer is stopped or draining: the request was not run
    (retryable), as opposed to an internal error."""


class _Slot(list):
    """One buffer of the staging ring: a padded batch's (cams, lidar,
    radars) host tensors, and the CUDA events behind the copies that last
    read them."""

    def __init__(self, tensors):
        super().__init__(tensors)
        self.events: List[torch.cuda.Event] = []


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
        aot_path: Optional[str] = None,
        devices: Optional[Sequence] = None,
    ):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        # rows: replicas (the data axis); columns: the view axis
        grid = [[resolve_device(d) for d in (row if isinstance(row, (list, tuple)) else [row])]
                for row in (devices or [device])]
        if len({len(row) for row in grid}) != 1:
            raise ValueError(f"every row of the devices grid needs as many devices: {devices}")
        self.devices = [row[0] for row in grid]
        self.device = self.devices[0]
        n = len(self.devices)
        if batch_size % n:
            raise ValueError(f"batch_size {batch_size} must divide by the mesh's data axis ({n}) for sharded serving")
        if aot_path is not None and (n > 1 or len(grid[0]) > 1):
            raise ValueError("aot_path and mesh are mutually exclusive: the AOT artifact was traced unpartitioned")
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
        self.fold_bn = fold_bn
        self.post_process = PostProcessSpec.resolve(self.config, self.compat, ("inference", "test"), score_threshold)
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
        # (model, device, stream) of each replica; the first is `self.model`
        self.replicas = [(self.model, self.device, None)]
        if n > 1:
            self.replicas = [
                (self.model if i == 0 else copy.deepcopy(self.model).to(dev), dev,
                 torch.cuda.Stream(dev) if dev.type == "cuda" else None)
                for i, dev in enumerate(self.devices)
            ]
        if len(grid[0]) > 1 and self.spec.use_camera:
            for (replica, _, _), row in zip(self.replicas, grid):
                replica.shard_views(LocalViews(replica.camera_encoder, row))

        self.decode = centernet_decoder(self.spec, self.compat, eval_path=True)

        self.aot_meta = None
        if aot_path is not None:
            # the artifact's programs replace _serve; startup checks its
            # shapes, modalities, dtype, fold_bn and device against this server
            from .utils.aot import attach_aot_serving

            self.aot_meta = attach_aot_serving(self, aot_path)

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # fences submit()'s stopped-check + put against stop()'s drain
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "pinned_batches": 0, "padded_rows": 0,
                      "total_latency_s": 0.0, "queue_wait_s": 0.0, "slot_allocs": 0}
        self._launches = 0  # batches staged: the spans' batch numbers
        self._ring: Dict[tuple, List[_Slot]] = {}  # batch signature -> its two slots, the next first
        # one batch at a time is written and copied: the dispatch thread's,
        # or a `_run_batch` caller's
        self._staging = threading.Lock()

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
        pending = None  # (batch number, launched, futures, n, t_enqs, queue wait, pinned)
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
            t_enqs = [b[2] for b in batch]
            staged = time.perf_counter()
            wait = sum(staged - t for t in t_enqs)
            try:
                number, launched, pinned = self._launch([b[0] for b in batch], queue_wait_s=wait)
            except Exception as e:  # surface server errors to callers
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            if pending is not None:
                self._finish(*pending)
            pending = (number, launched, futures, len(batch), t_enqs, wait, pinned)
        if pending is not None:
            self._finish(*pending)

    def _serve(self, cams: torch.Tensor, lidar: torch.Tensor, radars: torch.Tensor):
        with torch.inference_mode():
            return self._serve_body(cams, lidar, radars)

    def _serve_body(self, cams: torch.Tensor, lidar: torch.Tensor, radars: torch.Tensor, model=None):
        """Forward + decode of one staged batch on `model` (the first
        replica by default); `utils.aot` exports it."""
        model = self.model if model is None else model
        batch = {"camera_imgs": cams, "lidar_points": lidar, "radar_points": radars}
        return self.decode(model(**model.forward_inputs(batch)))

    def _stage(self, samples: List[Dict]):
        """Samples (at most batch_size) -> the host tensors of one padded
        batch, and each replica's rows of it on the replica's device,
        copied on its stream: (cams, lidar, radars) as `_serve` takes them."""
        with self._staging:
            host = self._host_batch(samples)
            rows = self.batch_size // len(self.replicas)
            parts = []
            for i, (_, device, stream) in enumerate(self.replicas):
                with _on_stream(stream):
                    parts.append(self._to_device(host, device, slice(i * rows, (i + 1) * rows)))
        return host, parts

    def _host_batch(self, samples: List[Dict]) -> List[torch.Tensor]:
        """The (cams, lidar, radars) host tensors of one padded batch, in
        the samples' dtypes, written into the next slot of the batch
        signature's staging ring."""
        n = len(samples)
        if len({np.asarray(s["camera_imgs"]).dtype for s in samples}) > 1:
            # np.stack would promote uint8 rows to float without normalizing
            samples = [dict(s, camera_imgs=normalize_host_images(s["camera_imgs"]))
                       if np.asarray(s["camera_imgs"]).dtype == np.uint8 else s for s in samples]
        rows = [[np.asarray(s[key]) for s in samples] for key in ("camera_imgs", "lidar_points", "radar_points")]
        slot = self._slot(tuple((np.result_type(*(r.dtype for r in key_rows)), key_rows[0].shape)
                                for key_rows in rows))
        for key_rows, t in zip(rows, slot):
            out = t.numpy()
            np.stack(key_rows, out=out[:n])
            out[n:] = 0
        return slot

    def _slot(self, signature: tuple) -> _Slot:
        """The next slot of `signature`'s ring ((dtype, sample shape) a wire
        key), once the copies that last read it have completed. Both slots
        are allocated on the signature's first use, page-locked on a CUDA
        server, so that the copies from them are asynchronous."""
        slots = self._ring.get(signature)
        if slots is None:
            pin = self.device.type == "cuda"
            slots = self._ring[signature] = [
                _Slot(torch.empty((self.batch_size,) + shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                  pin_memory=pin) for dtype, shape in signature)
                for _ in range(2)
            ]
            self.stats["slot_allocs"] += len(slots)
        slot = slots.pop(0)
        slots.append(slot)
        for event in slot.events:
            event.synchronize()
        slot.events.clear()
        return slot

    def _to_device(self, host: _Slot, device: torch.device, rows: slice):
        """`rows` of a staged batch on `device`, copied on its current
        stream, an event recorded behind the copies; float inputs in the
        serving dtype (the uint8 wire stays uint8, normalized on the
        device)."""
        # copies on the CPU too: no device tensor aliases a slot that a
        # later batch rewrites
        cams, lidar, radars = (t[rows].to(device, non_blocking=True, copy=True) for t in host)
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            host.events.append(event)
        if cams.dtype != torch.uint8:
            cams = cams.to(self.dtype)
        return cams, lidar.to(self.dtype), radars.to(self.dtype)

    def _launch(self, samples: List[Dict], queue_wait_s: float = 0.0):
        """Stage and enqueue one batch without waiting for the device;
        returns the batch's number, a (host outputs, event) per replica and
        whether the batch was staged in page-locked memory.
        `queue_wait_s`, the batch's requests' summed wait before staging,
        is an attribute of its ``serve.stage`` span."""
        self._launches += 1
        number = self._launches
        with span("serve.stage", batch=number, requests=len(samples), queue_wait_s=queue_wait_s) as stage:
            host, parts = self._stage(samples)
            pinned = self.device.type == "cuda" and all(t.is_pinned() for t in host)
            stage.set(h2d_bytes=sum(t.nbytes for t in host), pinned=int(pinned))
        with span("serve.launch", batch=number):
            if len(self.replicas) == 1:
                return number, [self._enqueue_outputs(self._serve(*parts[0]), self.device)], pinned
            launched = []
            for args, (model, device, stream) in zip(parts, self.replicas):
                with _on_stream(stream):
                    with torch.inference_mode():
                        out = self._serve_body(*args, model=model)
                    launched.append(self._enqueue_outputs(out, device))
            return number, launched, pinned

    @staticmethod
    def _enqueue_outputs(out: Dict[str, torch.Tensor], device: torch.device):
        """The outputs' copies to the host, enqueued on the current stream,
        and an event after them (None on the CPU)."""
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    def _finish(self, number: int, launched, futures, n: int, t_enqs: List[float], queue_wait_s: float,
                pinned: bool) -> None:
        try:
            with span("serve.fetch", batch=number):
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
        self.stats["pinned_batches"] += int(pinned)
        self.stats["padded_rows"] += self.batch_size - n
        self.stats["total_latency_s"] += sum(now - t for t in t_enqs)
        self.stats["queue_wait_s"] += queue_wait_s

    def _fetch(self, launched, n: int) -> List[Dict]:
        for _, event in launched:
            if event is not None:
                event.synchronize()
        host = {k: torch.cat([part[k] for part, _ in launched]) for k in launched[0][0]}
        # boxes ship as (K, 9) = [x y z w l h yaw vx vy]
        boxes = np.concatenate(
            [host["boxes"].float().numpy(), host["velocities"].float().numpy()], axis=-1
        )
        scores = host["scores"].float().numpy()
        labels = host["labels"].numpy().astype(np.int64)
        pp = self.post_process
        return [filter_detections({"boxes": boxes[i], "scores": scores[i], "labels": labels[i]},
                                  pp.score_threshold, pp.nms_threshold, pp.max_detections) for i in range(n)]

    def _run_batch(self, samples: List[Dict]) -> List[Dict]:
        """Synchronous path (warmup, tests, timing): launch + fetch."""
        number, launched, _ = self._launch(samples)
        with span("serve.fetch", batch=number):
            return self._fetch(launched, len(samples))


def _on_stream(stream: Optional[torch.cuda.Stream]):
    """`stream` as the current stream (a replica's), or nothing for None."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


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
      GET  /stats   -> the server's request/batch/latency/queue-wait
                       counters, the uptime, the mean request latency and
                       the mean queue wait (submit to staging) in ms
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
                    st["mean_queue_wait_ms"] = st["queue_wait_s"] / st["requests"] * 1e3
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
