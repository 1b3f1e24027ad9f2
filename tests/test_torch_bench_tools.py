"""The port's latency and daemon-load tools on the CPU, twins of the JAX
package's ``scripts/bench_latency.py`` and
``scripts/bench_serve_concurrency.py``: one JSON line per batch size and
per mode, with the JAX scripts' keys (``scripts/bench_latency.py:117-122``,
``scripts/bench_serve_concurrency.py:120-127``); coalescing dispatches no
more often than single-flight; the latency tool's two paths give the same
map. 64x96, 2 sweeps."""

import json

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch import bench, bench_latency, bench_serve_concurrency

SIZE = ["--height", "64", "--width", "96", "--sweeps", "2"]
CPU = torch.device("cpu")
DIST = ["p50", "p90", "p99", "mean"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads per test process: the suite runs in several
    processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lines(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_bench_latency_one_line_per_batch(capsys):
    lines = _lines(bench_latency.main,
                   SIZE + ["--platform", "cpu", "--batches", "1,2",
                           "--requests", "2", "--warmup", "1"], capsys)
    assert [line["batch"] for line in lines] == [1, 2]
    for line in lines:
        assert list(line) == ["batch", "device_ms", "e2e_ms",
                              "device_img_per_sec"]
        for key in ("device_ms", "e2e_ms"):
            d = line[key]
            assert list(d) == DIST
            assert 0 < d["p50"] <= d["p90"] <= d["p99"]
        assert line["device_img_per_sec"] > 0


def test_bench_latency_paths_agree():
    """The resident path's map (``Predictor.infer``) is the end-to-end
    path's (``Predictor.predict``)."""
    args = bench_latency.build_parser().parse_args(
        SIZE + ["--platform", "cpu", "--dtype", "float32"])
    pred = bench_latency.make_predictor(args, CPU)
    host = bench.synthetic_batch(pred.cfg.sample_spec(), 2)
    got = pred.infer(bench.resident(host, CPU))
    assert got.shape == (2, 64, 96)
    np.testing.assert_array_equal(got.numpy(), pred.predict(host))


def test_bench_serve_concurrency_two_modes(capsys):
    lines = _lines(bench_serve_concurrency.main,
                   SIZE + ["--platform", "cpu", "--clients", "2",
                           "--requests", "4"], capsys)
    assert [line["mode"] for line in lines] == ["single-flight", "coalesced"]
    for line in lines:
        assert list(line) == ["mode", "clients", "requests", "req_per_s",
                              "p50_ms", "p99_ms", "device_dispatches"]
        assert line["clients"] == 2 and line["requests"] == 4
        assert line["req_per_s"] > 0
        assert 0 < line["p50_ms"] <= line["p99_ms"]
    single, coalesced = lines
    assert single["device_dispatches"] == 4
    assert 1 <= coalesced["device_dispatches"] <= single["device_dispatches"]


def test_bench_latency_from_a_run(tmp_path, capsys):
    """``--run``: the weights of a training run's checkpoint
    (``Predictor.from_run``), the flags giving its data and model config."""
    from radar_depth_tpu_torch.train import checkpoint
    from radar_depth_tpu_torch.train.main import run

    out = str(tmp_path / "run")
    run(["--arch", "resnet18_latefusion", "-b", "4", "--num-train", "8",
         "--num-val", "4", "--epochs", "1", "--output-dir", out,
         "--print-freq", "100", "--platform", "cpu", "--num-sweeps", "2",
         "--height", "64", "--width", "96"])
    capsys.readouterr()
    args = SIZE + ["--platform", "cpu", "--arch", "resnet18_latefusion",
                   "--dtype", "float32", "--run", out]
    lines = _lines(bench_latency.main, args + ["--batches", "2",
                                               "--requests", "1",
                                               "--warmup", "0"], capsys)
    assert [line["batch"] for line in lines] == [2]
    pred = bench_latency.make_predictor(
        bench_latency.build_parser().parse_args(args), CPU)
    want = checkpoint.load_payload(checkpoint.resolve_checkpoint(out))["model"]
    got = pred.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
