"""Requests through the port's `InferenceServer`, as the serve CLI builds
it, in a closed or an open loop.

Traffic parameters (the cell's ``traffic``):

- ``pool``: distinct seeded samples; ``lidar_real`` and ``radar_real``: the
  [low, high] number of real LiDAR points a sample and radar points a
  radar, the rest zero rows;
- ``batch_size``, ``max_delay_ms``, ``score_threshold``, ``bf16``,
  ``fold_bn``: the server's settings;
- ``arrivals``: ``closed`` (``clients`` callers, each sending its next
  sample when its reply comes) or ``poisson`` (``rate`` requests a second,
  open loop: the seed orders one fixed set of exponential gaps, so every
  seed offers the same gaps; each request is timed from when it was due);
- ``trace_batches``: served batches in the profiled sub-window;
  ``check_requests``: completed requests the check compares.

End-to-end: ``serve_samples_per_s`` (requests completed inside the window
over its length) and ``serve_p95_ms`` (the 95th percentile of every
request due in the window, a failed one counting as infinite).
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from core import common, compare, counts, inputs
from core.harness import Outcome, jax_tree

SETTLE_S = 60.0  # how long after the window a due request may still come


class _Record:
    __slots__ = ("sample", "client", "due", "sent", "done", "ok", "result")

    def __init__(self, sample: int, due: float, client=None):
        self.sample, self.client, self.due = sample, client, due
        self.sent = self.done = self.ok = self.result = None


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between ranks; infinite where either
    neighbouring rank is (a failed request)."""
    v = np.sort(np.asarray(values, np.float64))
    if not len(v):
        return math.inf
    pos = q / 100 * (len(v) - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if not math.isfinite(v[hi]):
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def _faults(server, faults):
    """Break the timed path underneath (the harness's own tests)."""
    if "half_batch" in faults:
        host_batch = server._host_batch

        def halved(samples):  # the second half of each batch left out: sample 0 in its place
            n = len(samples)
            return host_batch(samples[: n // 2] + samples[:1] * (n - n // 2) if n > 1 else samples)
        server._host_batch = halved
    if "answer_altered" in faults:
        fetch = server._fetch

        def altered(launched, n):
            out = fetch(launched, n)
            for res in out:
                if len(res["scores"]):
                    res["boxes"] = res["boxes"].copy()
                    res["boxes"][0, 0] += 0.5
            return out
        server._fetch = altered


def run(ctx) -> Outcome:
    from bevfusion_multimodal_3d_object_detection_tpu_torch.serving import InferenceServer
    from bevfusion_multimodal_3d_object_detection_tpu_torch.utils.cache import enable_compilation_cache

    t, spec, dev = ctx.traffic, ctx.spec, ctx.device
    enable_compilation_cache()
    pool = inputs.samples(spec, t["pool"], ctx.seed, dev, t["lidar_real"], t["radar_real"])
    variables = common.make_weights(ctx, pool[:4])
    server = InferenceServer(config=ctx.config, batch_size=t["batch_size"], max_delay_ms=t["max_delay_ms"],
                             score_threshold=t["score_threshold"], use_bf16=t["bf16"], fold_bn=t["fold_bn"],
                             variables=jax_tree(variables), device=dev)
    server.start()
    _faults(server, ctx.faults)
    rng = inputs.host_rng(ctx.seed, 3)
    records: List[_Record] = []
    lock = threading.Lock()
    sub = common.SubWindow(ctx.trace)
    seconds = ctx.seconds

    def submit(rec: _Record) -> None:
        rec.sent = time.perf_counter()
        try:
            fut = server.submit(pool[rec.sample])
        except Exception:
            rec.done, rec.ok = rec.sent, False
            return
        fut.add_done_callback(lambda f, r=rec: finished(r, f))

    def finished(rec: _Record, fut) -> None:
        rec.done = time.perf_counter()
        rec.ok = fut.exception() is None
        if rec.ok:
            rec.result = fut.result()
        if rec.client is not None and rec.done < end:  # the caller's next request
            send(_Record((rec.sample + 1) % t["pool"], rec.done, rec.client))

    def send(rec: _Record) -> None:
        with lock:
            records.append(rec)
        submit(rec)

    closed = t["arrivals"] == "closed"
    stats0 = dict(server.stats)
    t0 = ctx.window_opens()
    end = t0 + seconds
    if closed:
        clients = t["clients"]
        first = rng.permutation(max(clients, t["pool"]))[:clients] % t["pool"]
        for c in range(clients):
            send(_Record(int(first[c]), t0, c))
    else:
        n = max(1, int(round(t["rate"] * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps = rng.permutation(gaps) * (seconds / gaps.sum())
        due = t0 + np.cumsum(gaps) - gaps[0]
        order = rng.integers(0, t["pool"], n)

        def generate():
            for d, s in zip(due, order):
                wait = d - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                send(_Record(int(s), float(d)))

        gen = threading.Thread(target=generate, daemon=True)
        gen.start()
    # the profiled sub-window: from a third of the window, `trace_batches` batches
    time.sleep(max(0.0, t0 + seconds / 3 - time.perf_counter()))
    b0 = server.stats["batches"]
    sub.begin()
    while ctx.trace and server.stats["batches"] - b0 < t["trace_batches"] and time.perf_counter() < end:
        time.sleep(0.005)
    sub.end()
    time.sleep(max(0.0, end - time.perf_counter()))
    stats1 = dict(server.stats)
    if not closed:
        gen.join()
    settle = time.perf_counter() + SETTLE_S
    while time.perf_counter() < settle:
        with lock:
            pending = [r for r in records if r.done is None]
        if not pending:
            break
        time.sleep(0.01)
    memory = ctx.memory_peak()
    server.stop()
    del server
    ctx.free()

    with lock:
        done = list(records)
    for r in done:
        if r.done is None:
            r.done, r.ok = math.inf, False
    completed = [r for r in done if r.ok and t0 <= r.done <= end]
    buckets = np.bincount([int((r.done - t0) // 2) for r in completed], minlength=int(math.ceil(seconds / 2)))
    print("serve: completions a 2 s bucket " + " ".join(str(int(b)) for b in buckets), file=sys.stderr)
    failed = sum(1 for r in done if not r.ok)
    e2e = {"serve_samples_per_s": len(completed) / seconds}
    if not closed:
        latencies = [(r.done - r.due) * 1e3 if r.ok else math.inf for r in done]
        e2e["serve_p95_ms"] = percentile(latencies, 95)
        late = max((r.sent - r.due for r in done if r.sent is not None), default=0.0)
        print(f"serve: {len(done)} requests due, the generator at most {late * 1e3:.3f} ms late", file=sys.stderr)
    in_sub = sum(1 for r in done if r.ok and sub.t0 <= r.done <= sub.t1)
    layer_data = {
        "model_flops": counts.model_flops(spec) * in_sub,
        "sub_window_s": sub.seconds,
        "server": {"requests": stats1["requests"] - stats0["requests"],
                   "batches": stats1["batches"] - stats0["batches"], "batch_size": t["batch_size"]},
        "b1_launch_flops": counts.b1_flops(spec, t["batch_size"]),
        "b1_dtype": "bf16" if t["bf16"] else "f32",
        "latencies_ms": None if closed else latencies,
    }
    trace = sub.summary()

    def check() -> Dict[str, float]:
        ok = [r for r in done if r.ok]
        chosen = [ok[i] for i in compare.sample_indices(len(ok), t["check_requests"], inputs.host_rng(ctx.seed, 9))]
        uniq = sorted({r.sample for r in chosen})
        maps = dict(zip(uniq, common.reference_maps(spec, variables, [pool[i] for i in uniq], dev)))
        voxel = common.decode_voxel(ctx.config)
        if "control" in ctx.faults:  # the reference in fp8 in the program's place
            low = dict(zip(uniq, common.reference_maps(spec, variables, [pool[i] for i in uniq], dev, "fp8")))
            dets = [common.decoded(low[r.sample], spec.max_detections, voxel, spec.pc_range, t["score_threshold"])
                    for r in chosen]
        else:
            dets = [r.result for r in chosen]
        return compare.detection_gaps(dets, [maps[r.sample] for r in chosen], voxel, spec.pc_range,
                                      spec.max_detections, t["score_threshold"])

    return Outcome(e2e, len(done), failed, memory, layer_data, check, trace)
