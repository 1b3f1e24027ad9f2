"""HTTP serving daemon around :class:`radar_depth_tpu_torch.inference.
Predictor`, on the card unless ``--platform cpu``, in one process or over
the ranks of a (data, space) mesh.

The port of ``radar_depth_tpu/serve.py``, function for function, with the
same wire format, so that a client of either daemon talks to both:

    python -m radar_depth_tpu_torch.serve --run runs/ms --port 8712
    python -m radar_depth_tpu_torch.serve --run runs/ms --platform cpu
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m radar_depth_tpu_torch.serve --run runs/ms --spatial 2

  POST /predict   body = npz (numpy savez) of schema batch arrays
                  (data/schema.py SAMPLE_KEYS, leading batch dim)
                  -> 200, body = npz {"depth": (B, H, W) float32 meters}
                  -> 400, body = JSON {"error": "..."} for a bad request
  GET  /healthz   -> 200 "ok" once the model is loaded and warmed, else 503

A request is checked against the schema before it reaches the predictor
(``check_batch``: the keys, trailing shapes and dtypes of the model's
``SampleSpec``, one batch size of at least 1); a bad one is answered 400.
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

Over ranks (``--spatial S`` under ``torchrun`` with a multiple of S ranks:
the (data, space) mesh of ``Predictor.from_run``, NCCL on
``cuda:LOCAL_RANK`` or gloo with ``--platform cpu``), rank 0 is the leader:
it alone binds the port, runs the HTTP handlers and the dispatcher, and
prints ``ready``. Every other rank is a follower (``DepthServer.follow``):
it receives the leader's messages one at a time on a gloo group of their
own, made right after the mesh's groups, and calls ``predict`` with each
batch it is sent, so that all ranks run the predict's collectives together.
On the leader the device thread sends each message (a header, then one
broadcast per array) and then runs its own predict: one thread issues every
collective of rank 0, in one order. The warmup's ladder takes the same
path, so ``/healthz`` says 200 only once every rank has run it; coalescing
stays on the leader, which sends the merged batch. The leader also sends
a keep-alive every ``keepalive_s`` (queued behind any predict), well
inside the control group's timeout, so that an idle daemon outlives it;
that timeout is then how long a follower whose leader is gone waits
before it fails. On SIGINT (or ``close``) the leader sends ``stop``; every
rank closes its predictor and exits 0, and each prints its count of
dispatches on its last line.

Faults over ranks: a request that fails ``check_batch`` never leaves rank
0. A failure after the broadcast (out of memory on one rank, a lost peer)
is fatal: that rank exits non-zero and torchrun ends the job; the ranks do
not try to resynchronise.

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
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from radar_depth_tpu_torch.data.schema import (
    SampleSpec,
    sample_dtypes,
    sample_shapes,
)

KEEPALIVE_S = 30.0  # over ranks: the leader's message interval while idle
CONTROL_TIMEOUT_S = 600.0  # over ranks: a follower's longest wait for one


def check_batch(batch: Dict[str, np.ndarray], spec: SampleSpec) -> int:
    """Raise ValueError unless ``batch`` holds exactly the schema's keys,
    each with its trailing shape under ``spec`` and its dtype, and one
    leading batch size of at least 1, which it returns."""
    shapes, dtypes = sample_shapes(spec), sample_dtypes()
    if set(batch) != set(shapes):
        raise ValueError(f"batch keys {sorted(batch)} != the schema's "
                         f"{sorted(shapes)}")
    sizes = set()
    for k, v in batch.items():
        if tuple(v.shape[1:]) != shapes[k] or v.ndim != len(shapes[k]) + 1:
            raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                             f"(B,) + {shapes[k]}")
        if v.dtype != dtypes[k]:
            raise ValueError(f"{k}: dtype {v.dtype}, expected {dtypes[k]}")
        sizes.add(v.shape[0])
    if len(sizes) != 1 or min(sizes) < 1:
        raise ValueError(f"batch sizes {sorted(sizes)}: expected one size "
                         ">= 1 for every key")
    return sizes.pop()


def _control_group(mesh, timeout_s: float):
    """The gloo group of the daemon's messages over ``mesh``'s ranks, made
    by every rank at the same point; None in one process."""
    if mesh is None or mesh.group is None or mesh.world == 1:
        return None
    import datetime

    import torch.distributed as dist

    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=timeout_s))


def _as_bytes(v: np.ndarray):
    """A uint8 tensor over the bytes of the C-contiguous array ``v``: what
    a broadcast sends from, or receives into."""
    import torch

    return torch.from_numpy(v.reshape(-1).view(np.uint8))


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
    ``.cfg`` with ``sample_spec()``: the port's ``Predictor``. If its
    ``mesh`` spans more than one rank, every rank builds its DepthServer at
    the same point (the control group is made here): rank 0's is the
    leader, which serves HTTP, and every other rank's a follower, which
    calls ``follow`` (module docstring). ``keepalive_s`` and
    ``control_timeout_s`` matter only over ranks."""

    def __init__(self, predictor, max_tile: int = 128,
                 batch_window_ms: float = 0.0,
                 keepalive_s: float = KEEPALIVE_S,
                 control_timeout_s: float = CONTROL_TIMEOUT_S):
        self.predictor = predictor
        self.max_tile = max_tile
        self.batch_window_ms = batch_window_ms
        self.keepalive_s = keepalive_s
        self.spec = predictor.cfg.sample_spec()
        self.ready = False
        self.dispatch_count = 0  # device dispatches (observability, tests)
        self.predict_calls = 0  # predict calls, the warmup's included
        # over ranks: the leader's predict messages, their bytes and host
        # seconds; the failure that ended the server; a callback for it
        self.broadcast = {"messages": 0, "bytes": 0, "seconds": 0.0}
        self.fatal: Optional[BaseException] = None
        self.on_fatal = None
        mesh = getattr(predictor, "mesh", None)
        self._control = _control_group(mesh, control_timeout_s)
        self.is_leader = self._control is None or mesh.rank == 0
        self._queue: list = []
        self._qcv = threading.Condition()
        self._stop = False
        self._stopped_ranks = False
        self._device = self._dispatcher = self._keepalive = None
        if not self.is_leader:
            return
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="rdt-device")
        if batch_window_ms > 0:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True)
            self._dispatcher.start()
        if self._control is not None:
            self._closing = threading.Event()
            self._keepalive = threading.Thread(
                target=self._keepalive_loop, daemon=True,
                name="rdt-keepalive")
            self._keepalive.start()

    # ---- the device thread (the leader's, or the only one)

    def _guarded(self, fn, *args):
        """``fn(*args)``, run on the device thread. Over ranks a failure
        there is fatal (module docstring): it is recorded with its
        traceback, ends the server (``on_fatal``) and refuses every later
        call."""
        if self.fatal is not None:
            raise RuntimeError("the server failed") from self.fatal
        try:
            return fn(*args)
        except Exception as e:
            if self._control is not None:
                traceback.print_exc()
                self.fatal = e
                self.ready = False
                if self.on_fatal is not None:
                    self.on_fatal(e)
            raise

    def _run(self, fn, *args):
        """``fn(*args)`` on the device thread, waited for."""
        return self._device.submit(self._guarded, fn, *args).result()

    def _predict(self, batch, op: str = "predict") -> np.ndarray:
        """On the device thread: over ranks, send ``batch`` to the
        followers first; then predict."""
        if self._control is not None:
            self._send(op, batch)
        self.predict_calls += 1
        return np.asarray(self.predictor.predict(batch,
                                                 max_tile=self.max_tile))

    def _send(self, op: str, batch=None) -> None:
        """The leader's message: a header (op, max_tile, each array's key,
        shape and dtype), then one broadcast of each array's bytes."""
        import torch.distributed as dist

        arrays = [] if batch is None else [
            (k, np.require(v, requirements=("C", "W")))
            for k, v in sorted(batch.items())]
        t0 = time.perf_counter()
        header = (op, self.max_tile,
                  [(k, v.shape, v.dtype.str) for k, v in arrays])
        dist.broadcast_object_list([header], src=0, group=self._control)
        for _, v in arrays:
            dist.broadcast(_as_bytes(v), src=0, group=self._control)
        if arrays:
            self.broadcast["messages"] += 1
            self.broadcast["bytes"] += sum(v.nbytes for _, v in arrays)
            self.broadcast["seconds"] += time.perf_counter() - t0

    def _keepalive_loop(self):
        while not self._closing.wait(self.keepalive_s):
            try:
                self._device.submit(self._guarded, self._send, "keepalive")
            except RuntimeError:  # the device thread was shut down
                return

    def follow(self) -> int:
        """A follower's loop: receive the leader's messages one at a time
        and act on each (``predict`` and ``warmup``: call the predictor with
        the batch; ``keepalive``: nothing; ``stop``: return the count of
        dispatches). An error, a lost leader's timeout included, raises."""
        import torch.distributed as dist

        if self.is_leader:
            raise RuntimeError("follow() runs on a follower rank")
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self._control)
            op, max_tile, specs = msg[0]
            if op == "stop":
                return self.dispatch_count
            batch = {}
            for k, shape, dtype in specs:
                batch[k] = np.empty(shape, np.dtype(dtype))
                dist.broadcast(_as_bytes(batch[k]), src=0,
                               group=self._control)
            if op == "keepalive":
                continue
            self.predictor.predict(batch, max_tile=max_tile)
            self.predict_calls += 1
            if op == "predict":
                self.dispatch_count += 1

    def warmup(self) -> None:
        """Run the predictor at every power-of-two tile up to max_tile, on
        the device thread (over ranks: on every rank), before marking
        ready. Torch compiles nothing, but the first call at a shape loads
        the kernels' libraries and builds cuDNN's plans for that shape on
        that thread; warming the whole tile ladder moves that cost from the
        first requests to start-up."""
        from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes

        batch = SyntheticNuScenes(self.max_tile, spec=self.spec,
                                  seed=0).batch(range(self.max_tile))

        def ladder():
            n = 1
            while n <= self.max_tile:
                self._predict({k: v[:n] for k, v in batch.items()}, "warmup")
                n *= 2

        self._run(ladder)
        self.ready = True

    def _dispatch(self, batch) -> np.ndarray:
        """One device dispatch: predict on the device thread, waited for."""

        def call():
            self.dispatch_count += 1
            return self._predict(batch)

        return self._run(call)

    def predict_npz(self, body: bytes) -> bytes:
        batch = {k: v for k, v in np.load(io.BytesIO(body)).items()}
        check_batch(batch, self.spec)
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
        flight finishes, and no new one starts. Over ranks the leader then
        sends ``stop`` on the device thread, once, unless the server failed.
        A follower has nothing to close."""
        if not self.is_leader:
            return
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
        if self._keepalive is not None:
            self._closing.set()
            self._keepalive.join()
        if (self._control is not None and self.fatal is None
                and not self._stopped_ranks):
            self._stopped_ranks = True
            self._run(self._send, "stop")
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


def run_daemon(predictor, host: str, port: int, *, max_tile: int = 128,
               batch_window_ms: float = 0.0,
               keepalive_s: float = KEEPALIVE_S,
               control_timeout_s: float = CONTROL_TIMEOUT_S) -> DepthServer:
    """Serve ``predictor`` on ``host:port`` until SIGINT: bind, warm up
    (``/healthz`` says 503 meanwhile), print ``ready``, serve. Over ranks
    every rank calls this with its predictor: a follower follows the leader
    until it sends ``stop``. Each rank prints its counts as one JSON line
    last and returns its server; a fatal failure raises."""
    srv = DepthServer(predictor, max_tile=max_tile,
                      batch_window_ms=batch_window_ms,
                      keepalive_s=keepalive_s,
                      control_timeout_s=control_timeout_s)
    mesh = getattr(predictor, "mesh", None)
    ranks = 1 if mesh is None else mesh.world

    def counts(role, **extra):
        print(json.dumps({"rank": 0 if mesh is None else mesh.rank,
                          "role": role, "dispatches": srv.dispatch_count,
                          "predict_calls": srv.predict_calls, **extra}),
              flush=True)

    if not srv.is_leader:
        srv.follow()
        counts("follower")
        return srv
    httpd = srv.serve(host, port)
    srv.on_fatal = lambda e: threading.Thread(target=httpd.shutdown,
                                              daemon=True).start()
    http = threading.Thread(target=httpd.serve_forever, daemon=True,
                            name="rdt-http")
    http.start()
    cfg = predictor.cfg
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(arch={cfg.arch}, {cfg.height}x{cfg.width}, max_tile={max_tile}, "
          f"{predictor.device}, {ranks} rank(s)); warming up...", flush=True)
    try:
        srv.warmup()
        print("ready", flush=True)
        while http.is_alive():  # until SIGINT, or a fatal failure stops it
            http.join(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    if srv.fatal is not None:
        raise RuntimeError("the daemon failed after a broadcast; the other "
                           "ranks cannot go on") from srv.fatal
    counts("leader", broadcast=srv.broadcast)
    return srv


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
                   help="serve over a (data, space) mesh of the torchrun "
                        "ranks, image height sharded over this many "
                        "(default: the run's own setting)")
    p.add_argument("--keepalive-s", type=float, default=KEEPALIVE_S,
                   help="over ranks: the leader's message interval while "
                        "idle")
    p.add_argument("--control-timeout-s", type=float,
                   default=CONTROL_TIMEOUT_S,
                   help="over ranks: how long a follower waits for the "
                        "leader's next message before it fails")
    p.add_argument("--platform", default="default", choices=["default", "cpu"],
                   help="'default' serves on the CUDA card (and fails "
                        "without one); 'cpu' serves on the CPU")
    args = p.parse_args(argv)

    from radar_depth_tpu_torch.device import resolve_device
    from radar_depth_tpu_torch.inference import Predictor

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    overrides = {"spatial": args.spatial} if args.spatial > 1 else {}
    predictor = Predictor.from_run(args.run, device=device, **overrides)
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if predictor.mesh is None and world > 1:
            raise ValueError(
                f"{world} ranks without --spatial: every rank would bind "
                "the port; serve from one process, or over ranks with "
                "--spatial S (S dividing the ranks)")
        run_daemon(predictor, args.host, args.port, max_tile=args.max_tile,
                   batch_window_ms=args.batch_window_ms,
                   keepalive_s=args.keepalive_s,
                   control_timeout_s=args.control_timeout_s)
    finally:
        predictor.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
