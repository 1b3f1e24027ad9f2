"""The port's HTTP daemon over ranks (``serve.py --spatial 2``) on the CPU:
one launch of four gloo ranks, a (data 2, space 2) mesh, of
``python -m radar_depth_tpu_torch.serve --run RUN --spatial 2 --platform cpu
--max-tile 4 --batch-window-ms 5``, each rank started directly with
torchrun's variables so that rank 0 alone can be signalled.

The run directory is written with the port's own config and checkpoint
writers: the flagship (resnet18_multistage / upproj) at 128x96, 2 sweeps
(H=64 fails the JAX spatial check), its weights JAX variables drawn from a
seed and converted, so that the JAX Predictor serves the same weights
without a training run.

- ``/healthz`` answers 503 during the warmup, then 200;
- single-flight requests of B=1, 3 (ragged over data 2) and 5 (two tiles)
  match the JAX Predictor within atol 2e-4 / rtol 1e-3 and the port's
  single-process Predictor within rtol = atol = 1e-5;
- concurrent one-sample requests under the 5 ms window are coalesced;
- a malformed body (a missing key; a wrong trailing shape) answers 400
  with its JSON error, and the next request is served;
- a request after an idle gap longer than the control group's timeout is
  served (the leader's keep-alives);
- SIGINT to rank 0 ends all four ranks with exit code 0, and every
  follower's count of dispatches equals the leader's.

Every wait has a timeout, and every process is killed in a finally block.
"""

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig as JaxData
from radar_depth_tpu.config import ModelConfig as JaxModel
from radar_depth_tpu.config import TrainConfig as JaxTrain
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.models import create_model
from radar_depth_tpu_torch.serve import check_batch
from radar_depth_tpu_torch.train.checkpoint import CheckpointManager
from radar_depth_tpu_torch.train.state import create_train_state
from tests.test_torch_models import random_jax_variables

ARCH, DECODER = "resnet18_multistage", "upproj"
H, W, SWEEPS = 128, 96, 2
SPEC = SampleSpec(height=H, width=W, num_sweeps=SWEEPS)
WORLD, SPACE, MAX_TILE, WINDOW_MS = 4, 2, 4, 5.0
KEEPALIVE_S, CONTROL_TIMEOUT_S = 0.5, 5.0
IDLE_S = CONTROL_TIMEOUT_S + 2.0  # longer than the control group's timeout
SINGLE_FLIGHT = (1, 3, 5)  # rows [0:1], [1:4], [4:9] of the request pool
CONCURRENT = 6  # one-sample requests, rows 9..14
START_TIMEOUT_S = 600  # the ranks' start and warmup
TIMEOUT = 300  # every request and join
EXIT_TIMEOUT_S = 60  # every rank's exit after SIGINT to rank 0
JAX_TOL = dict(atol=2e-4, rtol=1e-3)  # as tests/test_torch_serve.py
PORT_TOL = dict(rtol=1e-5, atol=1e-5)  # as tests/test_torch_spatial_trainer.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _free_ports(n):
    """``n`` distinct free ports, their sockets held open together."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _npz(batch) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **batch)
    return buf.getvalue()


def _post(url, batch_or_body):
    """(status, depth or the JSON error) of a POST to /predict."""
    body = (batch_or_body if isinstance(batch_or_body, bytes)
            else _npz(batch_or_body))
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, np.load(io.BytesIO(r.read()))["depth"]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _write_run(run_dir, variables):
    """config.json and one checkpoint, through the port's own writers."""
    cfg = config.TrainConfig(
        data=config.DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=config.ModelConfig(arch=ARCH, decoder=DECODER),
        output_dir=run_dir)
    os.makedirs(run_dir)
    config.save_config(cfg, os.path.join(run_dir, "config.json"))
    model = create_model(ARCH, device="cpu", decoder=DECODER,
                         output_size=(H, W))[0]
    sd = state_dict_from_jax_variables(variables, like=model.state_dict())
    model.load_state_dict(sd)
    ckpt = CheckpointManager(run_dir)
    ckpt.save(0, create_train_state(model, cfg.optim, 1), {"rmse": 1.0},
              wait=True)
    ckpt.close()
    return cfg, sd


class _HealthPoller(threading.Thread):
    """Polls /healthz every 50 ms from the launch on, recording each
    answer (a refused connection is no answer), until it reads 200."""

    def __init__(self, url, procs):
        super().__init__(daemon=True)
        self.url, self.procs, self.codes = url, procs, []

    def run(self):
        deadline = time.monotonic() + START_TIMEOUT_S
        while time.monotonic() < deadline:
            if any(p.poll() is not None for p in self.procs):
                return
            try:
                with urllib.request.urlopen(f"{self.url}/healthz",
                                            timeout=10) as r:
                    self.codes.append(r.status)
                    return
            except urllib.error.HTTPError as e:
                self.codes.append(e.code)
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(0.05)


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """Write the run, start the four ranks, compute the references while
    they warm up, and wait for /healthz; the ranks are killed on the way
    out if still running."""
    root = tmp_path_factory.mktemp("serve_spatial")
    run_dir = str(root / "run")
    jcfg = JaxTrain(data=JaxData(height=H, width=W, num_sweeps=SWEEPS),
                    model=JaxModel(arch=ARCH, decoder=DECODER))
    jpred = JaxPredictor(jcfg, None, None)
    variables = random_jax_variables(
        jpred.model, (jnp.zeros((1, H, W, 3), jnp.float32),
                      jnp.zeros((1, H, W, 1), jnp.float32)), seed=21)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    cfg, sd = _write_run(run_dir, variables)

    port, master = _free_ports(2)
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "radar_depth_tpu_torch.serve", "--run",
           run_dir, "--spatial", str(SPACE), "--platform", "cpu",
           "--max-tile", str(MAX_TILE), "--batch-window-ms", str(WINDOW_MS),
           "--keepalive-s", str(KEEPALIVE_S), "--control-timeout-s",
           str(CONTROL_TIMEOUT_S), "--port", str(port)]
    procs, logs = [], []
    try:
        for rank in range(WORLD):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(master), PYTHONPATH=REPO,
                       OMP_NUM_THREADS="1")
            out = open(root / f"rank{rank}.out", "w+")
            err = open(root / f"rank{rank}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                          stderr=err, start_new_session=True))
        poller = _HealthPoller(url, procs)
        poller.start()

        pool = SyntheticNuScenes(sum(SINGLE_FLIGHT) + CONCURRENT + 2,
                                 spec=SPEC, seed=5).batch(
            range(sum(SINGLE_FLIGHT) + CONCURRENT + 2))
        n_ref = sum(SINGLE_FLIGHT) + CONCURRENT
        ref = _rows(pool, 0, n_ref)
        jax_depth = jpred.predict(ref, max_tile=MAX_TILE)
        port_depth = Predictor(config.serve_config(cfg), sd,
                               device="cpu").predict(ref, max_tile=MAX_TILE)
        poller.join(START_TIMEOUT_S)

        def logs_text():
            text = []
            for rank, (out, err) in enumerate(logs):
                for f in (out, err):
                    f.flush()
                    f.seek(0)
                text.append(f"--- rank {rank}:\n{out.read()[-2000:]}\n"
                            f"{err.read()[-4000:]}")
            return "\n".join(text)

        assert poller.codes and poller.codes[-1] == 200, logs_text()
        yield {"url": url, "procs": procs, "codes": poller.codes,
               "pool": pool, "jax": jax_depth, "port": port_depth,
               "logs": logs, "logs_text": logs_text}
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=TIMEOUT)
        for out, err in logs:
            out.close()
            err.close()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------- the schema check alone


def _bad(kind):
    batch = SyntheticNuScenes(2, spec=SPEC, seed=1).batch(range(2))
    if kind == "missing key":
        del batch["intrinsics"]
    elif kind == "extra key":
        batch["extra"] = np.zeros((2, 3), np.float32)
    elif kind == "trailing shape":
        batch["radar_points"] = batch["radar_points"][:, :, :7]
    elif kind == "rank":
        batch["intrinsics"] = batch["intrinsics"][0]
    elif kind == "dtype":
        batch["image"] = batch["image"].astype(np.float32)
    elif kind == "batch sizes":
        batch["image"] = batch["image"][:1]
    elif kind == "empty batch":
        batch = {k: v[:0] for k, v in batch.items()}
    return batch


@pytest.mark.parametrize("kind,message", [
    ("missing key", "batch keys"), ("extra key", "batch keys"),
    ("trailing shape", "radar_points: shape"), ("rank", "intrinsics: shape"),
    ("dtype", "image: dtype"), ("batch sizes", "batch sizes"),
    ("empty batch", "batch sizes")])
def test_check_batch_refuses(kind, message):
    """What the leader refuses before anything is sent to the followers."""
    with pytest.raises(ValueError, match=message):
        check_batch(_bad(kind), SPEC)


def test_check_batch_takes_a_schema_batch():
    assert check_batch(SyntheticNuScenes(3, spec=SPEC, seed=1).batch(
        range(3)), SPEC) == 3


# ------------------------------------------------- the daemon over ranks


def test_healthz_503_then_200(daemon):
    codes = daemon["codes"]
    assert 503 in codes and codes[-1] == 200, codes
    assert codes.index(503) < len(codes) - 1


@pytest.mark.parametrize("n", SINGLE_FLIGHT)
def test_single_flight_matches_jax_and_one_process(daemon, n):
    lo = sum(SINGLE_FLIGHT[:SINGLE_FLIGHT.index(n)])
    status, depth = _post(daemon["url"], _rows(daemon["pool"], lo, lo + n))
    assert status == 200, depth
    assert depth.shape == (n, H, W) and depth.dtype == np.float32
    np.testing.assert_allclose(depth, daemon["jax"][lo:lo + n], **JAX_TOL)
    np.testing.assert_allclose(depth, daemon["port"][lo:lo + n], **PORT_TOL)


def test_concurrent_requests_are_answered_each_its_own(daemon):
    """Each client gets its own sample's map; the count of dispatches they
    took is read from the leader's last line (``test_sigint_stops``)."""
    lo = sum(SINGLE_FLIGHT)
    results = {}

    def client(i):
        results[i] = _post(daemon["url"],
                           _rows(daemon["pool"], lo + i, lo + i + 1))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CONCURRENT)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client hung"
    for i in range(CONCURRENT):
        status, depth = results[i]
        assert status == 200, depth
        np.testing.assert_allclose(depth[0], daemon["port"][lo + i],
                                   **PORT_TOL)


@pytest.mark.parametrize("kind,message", [
    ("missing key", "batch keys"), ("trailing shape", "radar_points: shape")])
def test_malformed_body_answers_400_then_serves(daemon, kind, message):
    status, error = _post(daemon["url"], _bad(kind))
    assert status == 400 and message in error["error"], error
    n = sum(SINGLE_FLIGHT) + CONCURRENT
    status, depth = _post(daemon["url"], _rows(daemon["pool"], n, n + 1))
    assert status == 200 and depth.shape == (1, H, W), depth


def test_serves_after_an_idle_gap_longer_than_the_timeout(daemon):
    time.sleep(IDLE_S)
    n = sum(SINGLE_FLIGHT) + CONCURRENT + 1
    status, depth = _post(daemon["url"], _rows(daemon["pool"], n, n + 1))
    assert status == 200 and depth.shape == (1, H, W), depth
    assert all(p.poll() is None for p in daemon["procs"])


def test_sigint_stops_every_rank_with_equal_counts(daemon):
    """Rank 0 alone is signalled: it sends stop, and every rank exits 0
    with its counts on its last line. The six concurrent requests took
    fewer than six dispatches (coalesced)."""
    procs = daemon["procs"]
    os.kill(procs[0].pid, signal.SIGINT)
    deadline = time.monotonic() + EXIT_TIMEOUT_S
    for p in procs:
        p.wait(timeout=max(1.0, deadline - time.monotonic()))
    assert [p.returncode for p in procs] == [0] * WORLD, daemon["logs_text"]()
    last = []
    for out, _ in daemon["logs"]:
        out.flush()
        out.seek(0)
        last.append(json.loads(out.read().strip().splitlines()[-1]))
    assert [r["rank"] for r in last] == list(range(WORLD))
    assert [r["role"] for r in last] == ["leader"] + ["follower"] * (WORLD - 1)
    leader = last[0]["dispatches"]
    assert all(r["dispatches"] == leader for r in last[1:]), last
    # single-flight 3, the two requests after a 400, the idle one: the rest
    # are the concurrent requests' dispatches
    concurrent = leader - len(SINGLE_FLIGHT) - 2 - 1
    assert 1 <= concurrent < CONCURRENT, last
    assert last[0]["broadcast"]["messages"] == last[0]["predict_calls"]
