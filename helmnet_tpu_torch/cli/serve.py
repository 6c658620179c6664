"""HTTP serving front end over SolverService (stdlib only), port of
`helmnet_tpu/cli/serve.py`.

    python -m helmnet_tpu_torch.cli.serve \\
        --checkpoint trained_models/tpu_r2c_best.npz --port 8871 --warmup 96

Endpoints:
  GET  /healthz   -> {"ok": true}
  GET  /stats     -> service counters (batches, occupancy, queue depth)
  POST /solve     -> body {"sos": [[...]], "source_location": [y, x] | null,
                           "iterations": 500}
                     reply {"wavefield": [[[re, im], ...]], "best_rmse": ...,
                            "rmse": [...], "latency_s": ...}

The handler threads block on the service's futures; the single worker
thread owns the card, so concurrency is bounded by micro-batching, not by
HTTP threads. A deployment reference, not a hardened proxy: put real
auth and limits in front of it.

`--checkpoint` takes an orbax run directory of the JAX package (its best
step, e.g. checkpoints/tpu_r3c1024), a flat params `.npz` or a
reference `.ckpt`, read with the default config. `--platform cuda` (the default) runs on the card and
raises without one; `--platform cpu` runs on the CPU. `--port 0` picks
a free port; the `serving on http://HOST:PORT` line names it.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/solve":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                out = service.solve(
                    np.asarray(req["sos"], np.float32),
                    source_location=req.get("source_location"),
                    source_map=req.get("source_map"),
                    iterations=req.get("iterations"),
                )
                self._reply(
                    200,
                    {
                        "wavefield": np.asarray(out["wavefield"]).tolist(),
                        "rmse": np.asarray(out["rmse"]).tolist(),
                        "best_rmse": out["best_rmse"],
                        "iterations": out["iterations"],
                        "batch_size": out["batch_size"],
                        "latency_s": out["latency_s"],
                    },
                )
            except (KeyError, ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # noqa: BLE001
                self._reply(500, {"error": str(exc)})

    return Handler


def serve_forever(service, host: str = "127.0.0.1", port: int = 8871):
    """Start the HTTP server on a background thread; returns (server, thread).

    port=0 picks a free port (see server.server_address).
    """
    server = ThreadingHTTPServer((host, port), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True,
                    help="orbax run directory, params .npz or reference .ckpt")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8871)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--chunk-iterations", type=int, default=100)
    ap.add_argument("--warmup", type=int, nargs="*", default=[96],
                    help="grid sizes to run once before accepting traffic")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                    help="device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    from ..core.config import Config
    from ..core.device import resolve_device
    from ..serve import ServeConfig, SolverService
    from ..solvers.iterative import IterativeSolver
    from .solve import load_checkpoint_params

    # cuda goes through the default, which raises without a card
    device = resolve_device(None if args.platform == "cuda" else args.platform)
    cfg = Config()
    params = load_checkpoint_params(args.checkpoint, cfg, device)
    service = SolverService(
        IterativeSolver(cfg, params=params, device=device),
        ServeConfig(max_batch=args.max_batch,
                    chunk_iterations=args.chunk_iterations),
    )
    if args.warmup:
        print(f"warming up sizes {args.warmup} ...", flush=True)
        service.warmup([(s, s) for s in args.warmup])
    server, thread = serve_forever(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        server.shutdown()
        service.shutdown()


if __name__ == "__main__":
    main()
