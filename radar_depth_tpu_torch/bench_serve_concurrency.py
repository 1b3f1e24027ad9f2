"""Concurrent load on the port's HTTP serving daemon, flag for flag the JAX
package's ``scripts/bench_serve_concurrency.py``: requests/s and latency
under N concurrent clients of ``serve.py::DepthServer``, single-flight
(window 0: one device dispatch per request, serialized on the device
thread) and then coalesced (window > 0: concurrent requests ride one device
batch). Seeded random weights: serving speed does not depend on them.

    python -m radar_depth_tpu_torch.bench_serve_concurrency [--platform cpu] \\
        [--height 96 --width 160 --sweeps 3] [--clients 8] [--requests 64]

Prints one JSON line per mode:
  {"mode": "single-flight"|"coalesced", "clients": N, "requests": N,
   "req_per_s": X, "p50_ms": X, "p99_ms": X, "device_dispatches": K}
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.request

import numpy as np

from radar_depth_tpu_torch.bench import open_device, seeded_predictor

TIMEOUT_S = 300  # for every request and every client


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--platform", default="default", choices=["default", "cpu"])
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--sweeps", type=int, default=3)
    p.add_argument("--arch", default="resnet18_latefusion")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=64,
                   help="total requests per mode (1 sample each)")
    p.add_argument("--window-ms", type=float, default=5.0)
    p.add_argument("--max-tile", type=int, default=8)
    return p


def make_predictor(args, dev):
    """A float32 Predictor of the flags' arch and size, seeded random
    weights."""
    from radar_depth_tpu_torch.config import ServeConfig

    return seeded_predictor(
        ServeConfig(arch=args.arch, height=args.height, width=args.width,
                    num_sweeps=args.sweeps), dev)


def run_mode(predictor, bodies, args, window_ms: float, label: str) -> dict:
    """One mode: a DepthServer on an ephemeral 127.0.0.1 port, warmed up,
    ``--clients`` threads each posting its own one-sample body in turn."""
    from radar_depth_tpu_torch.serve import DepthServer

    srv = DepthServer(predictor, max_tile=args.max_tile,
                      batch_window_ms=window_ms)
    srv.warmup()
    httpd = srv.serve("127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    lat: list = []
    lat_lock = threading.Lock()
    # ceil, so that no requested work is dropped and every client sends
    per_client = max(1, -(-args.requests // args.clients))

    errors: list = []

    def client(ci):
        try:
            for _ in range(per_client):
                t0 = time.perf_counter()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict", data=bodies[ci],
                    method="POST")
                with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                    np.load(io.BytesIO(r.read()))["depth"]
                dt = time.perf_counter() - t0
                with lat_lock:
                    lat.append(dt)
        except Exception as e:  # noqa: BLE001 — raised below, in main
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(args.clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise RuntimeError(f"{label}: a client did not finish in "
                               f"{TIMEOUT_S} s")
        if errors:
            raise RuntimeError(f"{label}: {len(errors)} client(s) failed"
                               ) from errors[0]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    return {"mode": label, "clients": args.clients, "requests": len(lat),
            "req_per_s": round(len(lat) / wall, 2),
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 1),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 1),
            "device_dispatches": srv.dispatch_count}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    predictor = make_predictor(args, open_device(args.platform))

    from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes

    ds = SyntheticNuScenes(max(args.clients, 8),
                           spec=predictor.cfg.sample_spec(), seed=3)
    bodies = []
    for i in range(args.clients):
        buf = io.BytesIO()
        np.savez(buf, **ds.batch([i % len(ds)]))
        bodies.append(buf.getvalue())
    for window_ms, label in ((0.0, "single-flight"),
                             (args.window_ms, "coalesced")):
        print(json.dumps(run_mode(predictor, bodies, args, window_ms, label)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
