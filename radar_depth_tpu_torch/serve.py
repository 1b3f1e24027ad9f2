"""HTTP serving daemon around :class:`radar_depth_tpu_torch.inference.
Predictor`, on the card unless ``--platform cpu``.

The port of ``radar_depth_tpu/serve.py``, function for function, with the
same wire format, so that a client of either daemon talks to both:

    python -m radar_depth_tpu_torch.serve --run runs/ms --port 8712
    python -m radar_depth_tpu_torch.serve --run runs/ms --platform cpu

  POST /predict   body = npz (numpy savez) of schema batch arrays
                  (data/schema.py SAMPLE_KEYS, leading batch dim)
                  -> 200, body = npz {"depth": (B, H, W) float32 meters}
                  -> 400, body = JSON {"error": "..."} for a bad request
  GET  /healthz   -> 200 "ok" once the model is loaded and warmed, else 503

Requests are tiled into power-of-two device batches (``Predictor.predict``).
Every call of the predictor, the warmup's included, runs on one long-lived
device thread, which serialises them as the JAX daemon's device lock does;
the handler threads (one per request) decode and encode npz bodies and wait.
One thread, not a lock, because PyTorch keeps cuDNN's execution plans per
thread: a predict on a fresh handler thread builds them again for every
convolution. With ``--batch-window-ms W`` > 0, a dispatcher thread coalesces
the requests that arrive within W ms and share array shapes into one device
batch of up to ``max_tile`` samples, and splits the depth maps back per
request; W=0 (the default) serves each request alone.

Client example:

    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, **batch)
    req = urllib.request.Request("http://host:8712/predict",
                                 data=buf.getvalue(), method="POST")
    out = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=60).read()))
    depth = out["depth"]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class _Pending:
    """One enqueued request awaiting the coalescing dispatcher."""

    __slots__ = ("batch", "n", "key", "event", "result", "error")

    def __init__(self, batch, key):
        self.batch = batch
        self.n = next(iter(batch.values())).shape[0]
        self.key = key  # shape signature: only like requests coalesce
        self.event = threading.Event()
        self.result = None
        self.error = None


class DepthServer:
    """Owns the predictor and the device thread; builds the HTTP server.

    ``predictor`` is any object with ``.predict(batch, max_tile)`` and a
    ``.cfg`` with ``sample_spec()``: the port's ``Predictor``."""

    def __init__(self, predictor, max_tile: int = 128,
                 batch_window_ms: float = 0.0):
        self.predictor = predictor
        self.max_tile = max_tile
        self.batch_window_ms = batch_window_ms
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="rdt-device")
        self.ready = False
        self._queue: list = []
        self._qcv = threading.Condition()
        self._stop = False
        self.dispatch_count = 0  # device dispatches (observability, tests)
        self._dispatcher = None
        if batch_window_ms > 0:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()

    def warmup(self) -> None:
        """Run the predictor at every power-of-two tile up to max_tile, on
        the device thread, before marking ready. Torch compiles nothing, but
        the first call at a shape loads the kernels' libraries and builds
        cuDNN's plans for that shape on that thread; warming the whole tile
        ladder moves that cost from the first requests to start-up."""
        from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes

        spec = self.predictor.cfg.sample_spec()
        batch = SyntheticNuScenes(self.max_tile, spec=spec,
                                  seed=0).batch(range(self.max_tile))

        def ladder():
            n = 1
            while n <= self.max_tile:
                self.predictor.predict({k: v[:n] for k, v in batch.items()},
                                       max_tile=self.max_tile)
                n *= 2

        self._device.submit(ladder).result()
        self.ready = True

    def _dispatch(self, batch) -> np.ndarray:
        """One device dispatch: predict on the device thread, waited for."""

        def call():
            self.dispatch_count += 1
            return np.asarray(self.predictor.predict(batch,
                                                     max_tile=self.max_tile))

        return self._device.submit(call).result()

    def predict_npz(self, body: bytes) -> bytes:
        batch = {k: v for k, v in np.load(io.BytesIO(body)).items()}
        if self.batch_window_ms > 0:
            depth = self._predict_coalesced(batch)
        else:
            depth = self._dispatch(batch)
        out = io.BytesIO()
        np.savez(out, depth=np.asarray(depth, np.float32))
        return out.getvalue()

    # ---- cross-request micro-batching (--batch-window-ms) ----

    def _predict_coalesced(self, batch) -> np.ndarray:
        key = tuple(sorted((k, v.shape[1:], str(v.dtype))
                           for k, v in batch.items()))
        p = _Pending(batch, key)
        with self._qcv:
            if self._stop:
                raise RuntimeError("server closed")
            self._queue.append(p)
            self._qcv.notify()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _dispatch_loop(self):
        while True:
            with self._qcv:
                while not self._queue and not self._stop:
                    self._qcv.wait()
                if self._stop:
                    # fail the queued requests instead of leaving their
                    # waiters in event.wait() forever
                    for p in self._queue:
                        p.error = RuntimeError("server closed")
                        p.event.set()
                    self._queue = []
                    return
            # the window: let concurrent requests land before dispatching
            time.sleep(self.batch_window_ms / 1000.0)
            with self._qcv:
                if not self._queue:
                    continue
                # Coalesce the oldest request's shape group, up to max_tile.
                # The head request always dispatches, even when n > max_tile
                # (predict tiles it, as in single-flight): else it would sit
                # at the head of the queue and starve every request behind.
                key = self._queue[0].key
                group = [self._queue[0]]
                total = group[0].n
                rest = []
                for p in self._queue[1:]:
                    if p.key == key and total + p.n <= self.max_tile:
                        group.append(p)
                        total += p.n
                    else:
                        rest.append(p)
                self._queue = rest
            try:
                if len(group) == 1:
                    merged = group[0].batch
                else:
                    merged = {k: np.concatenate([p.batch[k] for p in group])
                              for k in group[0].batch}
                depth = self._dispatch(merged)
                ofs = 0
                for p in group:
                    p.result = depth[ofs:ofs + p.n]
                    ofs += p.n
            except Exception as e:  # noqa: BLE001 — delivered per request
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()

    def close(self):
        """Stop the dispatcher and the device thread: every request still
        queued fails with RuntimeError("server closed"), the dispatch in
        flight finishes, and no new one starts."""
        with self._qcv:
            self._stop = True
            self._qcv.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)
        with self._qcv:  # anything that slipped in after the drain
            for p in self._queue:
                p.error = RuntimeError("server closed")
                p.event.set()
            self._queue = []
        self._device.shutdown(wait=False, cancel_futures=True)

    def handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet; stdout is the log
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    if server.ready:
                        self._send(200, b"ok", "text/plain")
                    else:
                        self._send(503, b"warming up", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = self.rfile.read(n)
                    self._send(200, server.predict_npz(body))
                except Exception as e:  # noqa: BLE001 — reported to the client
                    msg = json.dumps({"error": f"{type(e).__name__}: {e}"})
                    self._send(400, msg.encode(), "application/json")

        return Handler

    def serve(self, host: str, port: int) -> ThreadingHTTPServer:
        return ThreadingHTTPServer((host, port), self.handler())


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True, help="training run dir "
                   "(self-describing config.json; best checkpoint)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8712)
    p.add_argument("--max-tile", type=int, default=128,
                   help="device batch tile (a power of two)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce concurrent requests arriving within this "
                        "window into one device batch (0 = serialized "
                        "single-flight)")
    p.add_argument("--spatial", type=int, default=1,
                   help="serve over a (data, space) mesh, image height "
                        "sharded over this many ranks (not ported to the "
                        "daemon)")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' serves on the CUDA card (and fails "
                        "without one); 'cpu' serves on the CPU")
    args = p.parse_args(argv)

    from radar_depth_tpu_torch.device import resolve_device
    from radar_depth_tpu_torch.inference import Predictor

    if args.spatial > 1:
        raise NotImplementedError(
            f"--spatial {args.spatial}: the daemon serves from one process; "
            "serving over ranks is not ported (ROADMAP Queue A item 6)")
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    predictor = Predictor.from_run(args.run, device=device)
    srv = DepthServer(predictor, max_tile=args.max_tile,
                      batch_window_ms=args.batch_window_ms)
    print(f"serving {args.run} on http://{args.host}:{args.port} "
          f"(arch={predictor.cfg.arch}, {predictor.cfg.height}x"
          f"{predictor.cfg.width}, max_tile={args.max_tile}, {device}); "
          "warming up...", flush=True)
    srv.warmup()
    print("ready", flush=True)
    httpd = srv.serve(args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
