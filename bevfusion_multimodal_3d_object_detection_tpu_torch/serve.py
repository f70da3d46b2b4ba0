"""HTTP serving CLI of the port: the surface of the root ``serve.py``
(``:27-175``), on one GPU (``--data-parallel N``: N) unless ``--device cpu``:

  python -m bevfusion_multimodal_3d_object_detection_tpu_torch.serve
      --model checkpoints/best_model.msgpack [--config configs/base.yaml]
      [--host 127.0.0.1] [--port 8080] [--batch-size 8] [--max-delay-ms 5]
      [--score-threshold 0.3] [--f32] [--no-fold-bn] [--device cuda|cpu]
      [--data-parallel N] [--aot PATH | --export-aot PATH]

`serving.InferenceServer` (request coalescing into fixed-size batches,
bf16 and folded camera BatchNorms by default) behind
`serving.make_http_server`: GET /healthz, GET /stats (the server's counters,
the mean request latency ``mean_latency_s`` and the mean wait in the queue
before a request's batch is staged, ``mean_queue_wait_ms``), POST /infer.
Without ``--model`` it serves the seeded weights. With ``--port 0`` it binds a free
port and prints it. SIGTERM or SIGINT drains: the server stops accepting,
in-flight requests finish, and the process exits 0; a drain that takes
longer than ``--drain-timeout`` exits 1.

``--export-aot PATH`` writes the serving model's `torch.export` artifact
(`utils.aot`, both wire signatures, no weights) and exits; ``--aot PATH``
serves from one, with the weights of ``--model`` (or the seeded ones). The
two exclude each other, as in the JAX CLI. An artifact serves on the device
type it was exported on.

``--data-parallel N`` serves N replicas, one on each of ``cuda:0`` ..
``cuda:N-1`` (``InferenceServer(devices=...)``), each coalesced batch split
among them; more than ``torch.cuda.device_count()`` exits with the JAX
CLI's message. On the CPU it serves N replicas in the one process.
``--pallas`` is accepted and changes nothing: the port's eval path always
runs the fused PointNet kernel.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="HTTP serving of the detector")
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default="configs/base.yaml")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--score-threshold", type=float, default=0.3)
    ap.add_argument("--f32", action="store_true", help="serve in float32 (default bfloat16)")
    ap.add_argument("--no-fold-bn", action="store_true", help="keep BatchNorms in the serving model")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX CLI's surface and changes nothing: the port's eval "
                    "path always runs the fused PointNet kernel")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="execution device")
    ap.add_argument("--max-request-mb", type=float, default=64.0,
                    help="reject POST bodies larger than this with 413")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="max seconds to wait for in-flight requests on SIGTERM/SIGINT before forcing exit")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="serve N replicas on cuda:0..N-1, each batch split among them (batch size must divide by N)")
    ap.add_argument("--aot", default=None, metavar="PATH",
                    help="serve from an AOT artifact (utils/aot.py) instead of the live model code; "
                    "checks its shapes at startup")
    ap.add_argument("--export-aot", default=None, metavar="PATH",
                    help="export the serving model as an AOT artifact (torch.export, both wire "
                    "signatures) and exit")
    args = ap.parse_args(argv)
    if args.export_aot and args.aot:
        raise SystemExit(
            "--export-aot and --aot are mutually exclusive (exporting needs the live model, "
            "not a loaded artifact)"
        )
    if args.export_aot and args.data_parallel > 1:
        raise SystemExit(
            "--export-aot requires an unpartitioned server: drop --data-parallel for the export "
            "(artifacts are traced on one device; --data-parallel applies to live serving only)"
        )
    devices = None
    if args.data_parallel > 1:
        import torch

        if args.device == "cuda":
            n_dev = torch.cuda.device_count()
            if args.data_parallel > n_dev:
                raise SystemExit(
                    f"--data-parallel {args.data_parallel} needs that many devices, but only {n_dev} available"
                )
            devices = [f"cuda:{i}" for i in range(args.data_parallel)]
        else:
            devices = [args.device] * args.data_parallel

    from .serving import InferenceServer, make_http_server
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()

    server = InferenceServer(
        model_path=args.model,
        config_path=args.config,
        batch_size=args.batch_size,
        max_delay_ms=args.max_delay_ms,
        score_threshold=args.score_threshold,
        use_bf16=not args.f32,
        fold_bn=not args.no_fold_bn,
        device=None if devices else args.device,
        devices=devices,
        aot_path=args.aot,
    )
    if args.export_aot:
        from .utils.aot import export_serving_artifact

        meta = export_serving_artifact(server, args.export_aot)
        print(f"AOT artifact written to {args.export_aot} (batch={meta['batch_size']}, "
              f"signatures={meta['signatures']}, platforms={meta['platforms']})", flush=True)
        return
    source = f"AOT artifact {args.aot}" if args.aot else "the serving model"
    where = ", ".join(str(d) for d in server.devices)
    print(f"Warming up {source} (batch={args.batch_size}, {where}) ...", flush=True)
    with server:  # start() warms up before the socket opens
        httpd = make_http_server(server, args.host, args.port,
                                 max_request_bytes=int(args.max_request_mb * 1024 * 1024))
        # drain: stop accepting, let server_close join the in-flight handler
        # threads (non-daemon), then `with server` stops the dispatch
        httpd.daemon_threads = False
        httpd.block_on_close = True

        def _forced_exit():
            # the drain timed out: requests were dropped, so exit nonzero
            print(f"drain did not finish within {args.drain_timeout:.0f}s; forcing exit (requests dropped)",
                  flush=True)
            os._exit(1)

        def _drain(signum, frame):
            print(f"Signal {signum}: draining in-flight requests (timeout {args.drain_timeout:.0f}s)",
                  flush=True)
            threading.Thread(target=httpd.shutdown, daemon=True).start()
            watchdog = threading.Timer(args.drain_timeout, _forced_exit)
            watchdog.daemon = True
            watchdog.start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
        host, port = httpd.server_address[:2]
        print(f"Serving on http://{host}:{port} (POST /infer, GET /healthz, GET /stats)", flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    print("Drained; shutting down", flush=True)


if __name__ == "__main__":
    main()
