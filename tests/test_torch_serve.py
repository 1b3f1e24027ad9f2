"""The port's HTTP daemon (radar_depth_tpu_torch/serve.py) and export CLI
(radar_depth_tpu_torch/export_serving.py) on the CPU, over a tiny run that
the port's own train.main writes (resnet18 rgbd / deconv2, 64x96, 2 sweeps,
16 train / 8 val synthetic samples, 1 epoch), as tests/test_serve.py does
for the JAX daemon.

Every urlopen takes a timeout, every join is checked, and every server is
shut down in a finally block, so that a fault fails a test instead of
hanging the suite.
"""

import contextlib
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig, ModelConfig, TrainConfig
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu_torch import export_serving
from radar_depth_tpu_torch.config import ServeConfig
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor, load_serving
from radar_depth_tpu_torch.serve import DepthServer, main
from radar_depth_tpu_torch.train.main import run
from tests.test_torch_models import random_jax_variables

SPEC = SampleSpec(height=64, width=96, num_sweeps=2)
TIMEOUT = 60  # seconds, for every request and join
TOL = dict(atol=2e-4, rtol=1e-3)  # port vs JAX, as tests/test_torch_inference.py


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads per test process: the suite runs in several
    processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_run") / "run")
    run(["--arch", "resnet18", "--modality", "rgbd", "--decoder", "deconv2",
         "-b", "8", "--height", "64", "--width", "96", "--num-sweeps", "2",
         "--num-train", "16", "--num-val", "8", "--epochs", "1",
         "--output-dir", out, "--platform", "cpu", "--print-freq", "100"])
    return out


def npz(batch) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **batch)
    return buf.getvalue()


def post(url, body):
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 200
        return np.load(io.BytesIO(r.read()))["depth"]


def get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=TIMEOUT) as r:
        return r.status, r.read()


@contextlib.contextmanager
def serving(srv):
    """``srv`` over HTTP on an ephemeral localhost port, serve_forever on a
    thread; everything closed and joined on the way out."""
    httpd = srv.serve("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        srv.close()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive(), "serve_forever did not stop"


def join_all(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def test_round_trip_health_and_errors(tiny_run):
    """/healthz 503 before warmup and 200 after; a B=3 request equal to
    Predictor.predict; a malformed request answered by a 400 JSON error, the
    server still up; 404 elsewhere."""
    predictor = Predictor.from_run(tiny_run, device="cpu")
    srv = DepthServer(predictor, max_tile=8)
    with serving(srv) as url:
        with pytest.raises(urllib.error.HTTPError) as e:
            get(url, "/healthz")
        assert e.value.code == 503
        srv.warmup()
        assert get(url, "/healthz") == (200, b"ok")

        batch = SyntheticNuScenes(3, spec=SPEC, seed=7).batch(range(3))
        depth = post(url, npz(batch))
        assert depth.shape == (3, 64, 96) and depth.dtype == np.float32
        np.testing.assert_array_equal(depth, predictor.predict(batch,
                                                               max_tile=8))
        assert srv.dispatch_count == 1

        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, b"not an npz")
        assert e.value.code == 400
        assert e.value.headers["Content-Type"] == "application/json"
        assert "error" in json.loads(e.value.read())
        assert get(url, "/healthz") == (200, b"ok")
        for path in ("/nothing", "/predict"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(url, path)
            assert e.value.code == 404


def test_coalesces_concurrent_requests(tiny_run):
    """--batch-window-ms: 4 concurrent 1-sample requests ride one device
    dispatch (2 if a client thread misses the window), and each client gets
    its own sample's depth map back."""
    predictor = Predictor.from_run(tiny_run, device="cpu")
    srv = DepthServer(predictor, max_tile=8, batch_window_ms=200.0)
    srv.warmup()
    ds = SyntheticNuScenes(4, spec=SPEC, seed=11)
    bodies = [npz(ds.batch([i])) for i in range(4)]
    results = {}
    with serving(srv) as url:
        base = srv.dispatch_count

        def client(i):
            results[i] = post(url, bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        join_all(threads)
        assert sorted(results) == [0, 1, 2, 3]
        assert srv.dispatch_count - base <= 2, srv.dispatch_count - base
    expect = predictor.predict(ds.batch(range(4)), max_tile=8)
    for i in range(4):
        assert results[i].shape == (1, 64, 96)
        np.testing.assert_allclose(results[i][0], expect[i], rtol=1e-5,
                                   atol=1e-5)


def test_oversized_coalesced_request_is_served(tiny_run):
    """A request larger than max_tile dispatches in coalesced mode (predict
    tiles it) instead of wedging the head of the queue."""
    predictor = Predictor.from_run(tiny_run, device="cpu")
    srv = DepthServer(predictor, max_tile=4, batch_window_ms=50.0)
    big = SyntheticNuScenes(6, spec=SPEC, seed=13).batch(range(6))
    done = {}
    try:
        t = threading.Thread(target=lambda: done.update(
            depth=np.load(io.BytesIO(srv.predict_npz(npz(big))))["depth"]))
        t.start()
        join_all([t])
        assert done["depth"].shape == (6, 64, 96)
        np.testing.assert_array_equal(done["depth"],
                                      predictor.predict(big, max_tile=4))
        assert srv.dispatch_count == 1
    finally:
        srv.close()
    with pytest.raises(RuntimeError, match="server closed"):
        srv.predict_npz(npz(big))


def one_sample_body(cfg) -> bytes:
    """A valid one-sample request for a predictor of ``cfg``: the daemon
    checks every body against the schema before a predictor sees it."""
    return npz(SyntheticNuScenes(1, spec=cfg.sample_spec(),
                                 seed=1).batch([0]))


class _GatedPredictor:
    """A predictor whose predict waits for ``gate``: it holds the
    dispatcher so that later requests stay queued."""

    def __init__(self):
        self.cfg = ServeConfig(height=64, width=96, num_sweeps=2)
        self.started = threading.Event()
        self.gate = threading.Event()

    def predict(self, batch, max_tile):
        self.started.set()
        assert self.gate.wait(TIMEOUT)
        n = next(iter(batch.values())).shape[0]
        return np.zeros((n, 64, 96), np.float32)


class _ThreadRecorder:
    """A predictor that records the thread of each call."""

    def __init__(self):
        self.cfg = ServeConfig(height=64, width=96, num_sweeps=2)
        self.threads = []

    def predict(self, batch, max_tile):
        self.threads.append(threading.get_ident())
        n = next(iter(batch.values())).shape[0]
        return np.zeros((n, 64, 96), np.float32)


@pytest.mark.parametrize("window_ms", [0.0, 5.0])
def test_every_predict_runs_on_one_device_thread(window_ms):
    """The warmup and every request, from concurrent handler threads, run
    the predictor on one and the same thread, not a caller's: PyTorch keeps
    cuDNN's plans per thread."""
    pred = _ThreadRecorder()
    srv = DepthServer(pred, max_tile=4, batch_window_ms=window_ms)
    srv.warmup()
    assert len(pred.threads) == 3  # tiles 1, 2 and 4
    body = one_sample_body(pred.cfg)
    with serving(srv) as url:
        threads = [threading.Thread(target=post, args=(url, body))
                   for _ in range(6)]
        for t in threads:
            t.start()
        join_all(threads)
    assert len(pred.threads) == 3 + srv.dispatch_count
    if window_ms == 0:
        assert srv.dispatch_count == 6
    assert set(pred.threads) != {threading.get_ident()}
    assert len(set(pred.threads)) == 1


def test_close_fails_queued_stragglers():
    """close() fails every request still queued with RuntimeError("server
    closed"), lets the one in flight finish, and refuses new ones."""
    pred = _GatedPredictor()
    srv = DepthServer(pred, max_tile=4, batch_window_ms=1.0)
    body = one_sample_body(pred.cfg)
    out = {}

    def call(i):
        try:
            out[i] = srv.predict_npz(body)
        except RuntimeError as e:
            out[i] = e

    first = threading.Thread(target=call, args=(0,))
    first.start()
    assert pred.started.wait(TIMEOUT)
    rest = [threading.Thread(target=call, args=(i,)) for i in (1, 2)]
    for t in rest:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while len(srv._queue) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(srv._queue) == 2
    closer = threading.Thread(target=srv.close)
    closer.start()
    while not srv._stop and time.monotonic() < deadline:
        time.sleep(0.01)
    pred.gate.set()
    join_all([first, *rest, closer])
    assert np.load(io.BytesIO(out[0]))["depth"].shape == (1, 64, 96)
    for i in (1, 2):
        assert isinstance(out[i], RuntimeError)
        assert str(out[i]) == "server closed"
    with pytest.raises(RuntimeError, match="server closed"):
        srv.predict_npz(body)


def test_server_matches_jax_predictor():
    """A daemon over a JAX-converted state_dict answers what the JAX
    Predictor predicts from the same variables."""
    jcfg = TrainConfig(data=DataConfig(height=64, width=96, num_sweeps=2),
                       model=ModelConfig(arch="resnet18", modality="rgbd",
                                         decoder="deconv2"))
    jpred = JaxPredictor(jcfg, None, None)
    variables = random_jax_variables(
        jpred.model, (jnp.zeros((1, 64, 96, 4), jnp.float32),), seed=9)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    cfg = ServeConfig(arch="resnet18", modality="rgbd", decoder="deconv2",
                      height=64, width=96, num_sweeps=2)
    srv = DepthServer(Predictor(cfg, state_dict_from_jax_variables(variables),
                                device="cpu"), max_tile=4)
    srv.warmup()
    batch = SyntheticNuScenes(3, spec=SPEC, seed=5).batch(range(3))
    with serving(srv) as url:
        depth = post(url, npz(batch))
    np.testing.assert_allclose(depth, jpred.predict(batch), **TOL)


def test_main_refuses_spatial_and_a_missing_card(tiny_run, monkeypatch):
    """Under torchrun's WORLD_SIZE=2 without --spatial (the run's own is 1)
    main refuses with a ValueError, since every rank would bind the port;
    without --platform cpu and without a card, main raises."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="every rank would bind the port"):
        main(["--run", tiny_run, "--spatial", "1", "--platform", "cpu",
              "--port", "0"])
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--run", tiny_run, "--port", "0"])


def test_export_cli(tiny_run, tmp_path, capsys):
    """python -m radar_depth_tpu_torch.export_serving: a flag given
    overrides the run's config.json (here the z-buffer backend), the rest
    comes from it; the artifact serves what Predictor.predict does."""
    out = str(tmp_path / "tiny.pt2")
    assert export_serving.main(["--run", tiny_run, "--out", out, "--batch",
                                "2", "--raster-backend", "scatter",
                                "--platform", "cpu"]) == 0
    assert "exported" in capsys.readouterr().out
    graph = torch.export.load(out).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("rdt.zbuffer_min_depth.default") == 1
    assert targets.count("rdt.zbuffer_min_depth_sorted.default") == 0
    assert targets.count("rdt.batch_norm_relu.default") == 21
    assert targets.count("rdt.scale_bias_relu.default") == 0
    batch = SyntheticNuScenes(2, spec=SPEC, seed=3).batch(range(2))
    np.testing.assert_array_equal(
        load_serving(out, device="cpu")(batch),
        Predictor.from_run(tiny_run, device="cpu").predict(batch))
