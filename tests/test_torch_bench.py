"""The port's bench (``python -m radar_depth_tpu_torch.bench``) on the CPU,
against the JAX package's ``bench.py``:

- one infer iteration of the port against the JAX pipeline that
  ``bench.py:111-116`` runs, on JAX ``init_model`` variables carried across
  by ``convert.state_dict_from_jax_variables`` and the same
  ``SyntheticNuScenes(seed=0)`` batch: the maps within atol 2e-4, rtol 1e-3
  (the Predictor parity tolerance of tests/test_torch_inference.py: the
  preprocessed inputs are bit-identical, the forward differs by float32
  summation order), their sums within rtol 1e-4;
- every mode's one JSON line with ``--platform cpu``: ``bench.py``'s keys
  in its order, less ``vs_baseline`` and the v5e MFU keys; the card's keys
  absent on the CPU, with a note on stderr; the card keys' arithmetic with
  a card name given;
- train mode's loss equal to one ``make_train_step`` step's on the same
  resident batch (that step against JAX's: tests/test_torch_harness_step.py);
- the options and defaults of ``bench.py``, ``scripts/bench_latency.py`` and
  ``scripts/bench_serve_concurrency.py`` (read from ``--help`` in
  subprocesses) equal to the port's parsers', but for the added
  ``--platform``;
- without a card and without ``--platform cpu`` every entry point fails
  with ``device.py::as_device``'s error.

64x96, B=2, 2 sweeps, ``--iters 2 --warmup 1 --repeat 1``."""

import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu_torch import bench, bench_latency, bench_serve_concurrency
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data.packed import native_available
from radar_depth_tpu_torch.ops.preprocess import PreprocessConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, SWEEPS, B = 64, 96, 2, 2
SMALL = ["--height", str(H), "--width", str(W), "--sweeps", str(SWEEPS),
         "--batch", str(B), "--iters", "2", "--warmup", "1", "--repeat", "1",
         "--platform", "cpu"]
TOL = dict(atol=2e-4, rtol=1e-3)  # maps, as tests/test_torch_inference.py
SUM_RTOL = 1e-4
CPU = torch.device("cpu")
NO_CARD = ("radar_depth_tpu_torch runs on a CUDA device by default and none "
           "is available")
CARD_KEYS = ["gflops_per_image", "model_tflops_per_sec", "peak_tflops", "mfu",
             "device"]
# bench.py's keys per mode in its order (bench.py:155-165, :217-223,
# :357-378), less vs_baseline; train mode adds LOADER_KEYS where the native
# loader is built
KEYS = {
    "infer": ["metric", "value", "unit", "repeats", "min", "max", "mean"],
    "stream": ["metric", "value", "unit",
               "resident_images_per_sec_per_chip"],
    "train": ["metric", "value", "unit"],
    "train_accum2": ["metric", "value", "unit", "grad_accum"],
}
LOADER_KEYS = ["loader_img_per_sec", "loader_threads"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads per test process: the suite runs in several
    processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def own_tmp(tmp_path_factory):
    """The train mode's shard goes under a temp dir of this module."""
    prev = tempfile.tempdir
    tempfile.tempdir = str(tmp_path_factory.mktemp("bench_tmp"))
    yield
    tempfile.tempdir = prev


def _run(argv, capsys):
    """``bench.main(argv)`` in this process -> (its JSON lines, stderr)."""
    assert bench.main(argv) == 0
    captured = capsys.readouterr()
    return [json.loads(x) for x in captured.out.splitlines()], captured.err


def test_infer_iteration_matches_jax():
    from radar_depth_tpu.config import DataConfig, ModelConfig, TrainConfig
    from radar_depth_tpu.data.schema import SampleSpec as JaxSampleSpec
    from radar_depth_tpu.data.synthetic import SyntheticNuScenes as JaxData
    from radar_depth_tpu.models import create_model as jax_create_model
    from radar_depth_tpu.ops.preprocess import (
        PreprocessConfig as JaxPreprocessConfig,
        pack_model_inputs as jax_pack,
        prepare_eval_batch as jax_prepare,
    )
    from radar_depth_tpu.train.step import init_model

    args = bench.build_parser().parse_args(SMALL + ["--dtype", "float32"])
    jspec = JaxSampleSpec(height=H, width=W, num_sweeps=SWEEPS,
                          max_depth=80.0)
    jmodel, jarch = jax_create_model(args.arch, decoder="upproj",
                                     output_size=(H, W), dtype=jnp.float32)
    cfg = TrainConfig(data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
                      model=ModelConfig(arch=args.arch, dtype="float32"),
                      batch_size=B)
    variables = init_model(jmodel, jarch, cfg, jax.random.PRNGKey(0))
    pre = JaxPreprocessConfig(spec=jspec)

    @jax.jit
    def jax_iteration(variables, batch):  # bench.py:111-116
        prepared = jax_prepare(batch, pre)
        out = jmodel.apply(variables, *jax_pack(prepared, jarch.input_kind),
                           train=False)
        pred = out[1] if jarch.multistage else out
        return pred[..., 0], jnp.sum(pred.astype(jnp.float32))

    host = JaxData(B, spec=jspec, seed=0).batch(range(B))
    want, want_sum = jax_iteration(
        variables, {k: jnp.asarray(v) for k, v in host.items()})

    spec = bench.sample_spec(args)
    got_host = bench.synthetic_batch(spec, B)
    assert sorted(got_host) == sorted(host)
    for k, v in host.items():
        np.testing.assert_array_equal(got_host[k], v, err_msg=k)
    model, arch_spec = bench.build_model(args, CPU)
    model.load_state_dict(state_dict_from_jax_variables(variables))
    infer = bench.make_infer_fn(model, arch_spec,
                                PreprocessConfig(spec=spec), CPU)
    got = infer(bench.resident(got_host, CPU))
    assert got.shape == (B, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got.float().sum()), float(want_sum),
                               rtol=SUM_RTOL)


def test_threaded_samples_equal_serial():
    """The samples made in threads are the dataset's, made in turn."""
    from radar_depth_tpu_torch.data.synthetic import SyntheticNuScenes

    args = bench.build_parser().parse_args(SMALL)
    spec = bench.sample_spec(args)
    got = bench.synthetic_samples(spec, 4)
    ds = SyntheticNuScenes(4, spec=spec, seed=0)
    for i, g in enumerate(got):
        w = ds[i]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(got) == 4


@pytest.mark.parametrize("case,extra", [
    ("infer", ["--mode", "infer"]),
    ("stream", ["--mode", "stream"]),
    ("train", ["--mode", "train"]),
    ("train_accum2", ["--mode", "train", "--grad-accum", "2"]),
])
def test_mode_prints_one_line(case, extra, capsys):
    lines, err = _run(SMALL + extra, capsys)
    assert len(lines) == 1
    line = lines[0]
    want = KEYS[case]
    if case.startswith("train") and native_available():
        want = want + LOADER_KEYS
    assert list(line) == want
    assert line["unit"] == "img/s/chip"
    assert line["value"] > 0
    assert not set(CARD_KEYS) & set(line)
    if case == "infer":
        assert line["metric"] == "images_per_sec_per_chip"
        assert line["repeats"] == 1
        assert line["min"] <= line["value"] <= line["max"]
        assert "no card" in err
    if case == "stream":
        assert line["resident_images_per_sec_per_chip"] > 0
    if case == "train_accum2":
        assert line["grad_accum"] == 2


def test_card_keys_from_the_card_name(monkeypatch, capsys):
    """On a card of known peak the FLOP keys are the FlopCounterMode count
    times the rate over the peak; on an unknown card only its name, and a
    note on stderr."""
    from radar_depth_tpu_torch.model_summary import summarize

    args = bench.build_parser().parse_args(SMALL)
    flops = summarize(args.arch, H, W, "upproj")[2]
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: name)
    keys = bench.card_keys(torch.device("cuda"), args, 1000.0)
    assert list(keys) == CARD_KEYS
    assert keys["device"] == name
    assert keys["peak_tflops"] == 989.4
    assert keys["gflops_per_image"] == round(flops / 1e9, 2)
    tfs = flops * 1000.0 / 1e12
    assert keys["model_tflops_per_sec"] == round(tfs, 2)
    assert keys["mfu"] == round(tfs / 989.4, 4)
    f32 = bench.build_parser().parse_args(SMALL + ["--dtype", "float32"])
    assert bench.card_keys(torch.device("cuda"), f32, 1.0)[
        "peak_tflops"] == 66.9
    capsys.readouterr()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "Other")
    assert bench.card_keys(torch.device("cuda"), args, 1.0) == {
        "device": "Other"}
    assert "no dense bfloat16 peak known" in capsys.readouterr().err


def test_train_loss_equals_one_step():
    """The train mode's loss is one ``make_train_step`` step's on the same
    resident batch. That step, host-augmented as here, is held against the
    JAX package's jitted step in tests/test_torch_harness_step.py."""
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    args = bench.build_parser().parse_args(
        SMALL + ["--mode", "train", "--iters", "1", "--warmup", "0"])
    line, batch, loss = bench.bench_train(args, CPU)
    assert line["value"] > 0 and np.isfinite(loss)
    assert all(v.device == CPU for v in batch.values())
    assert batch["image"].shape == (B, H, W, 3)

    cfg = bench.train_config(args)
    model, spec = create_model(args.arch, device=CPU, decoder="upproj",
                               output_size=(H, W), dtype=torch.bfloat16,
                               param_dtype=torch.float32)
    init_random(model, 0)
    state = create_train_state(model, cfg.optim, steps_per_epoch=1000)
    step = make_train_step(model, spec, cfg,
                           host_augmented=native_available())
    sums = step(state, batch,
                generator=torch.Generator(device=CPU).manual_seed(0))
    assert float(sums["loss"]) == loss


# ------------------------------------------------------------ flags

# Run a script with --help, its parser printing its options and defaults
# as JSON in place of the help text.
DUMP = r"""
import argparse, json, runpy, sys

def dump(self, file=None):
    print(json.dumps({"/".join(a.option_strings): [a.default, a.choices]
                      for a in self._actions}))

argparse.ArgumentParser.print_help = dump
sys.argv = [sys.argv[1], "--help"]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
SCRIPTS = {"bench": "bench.py", "bench_latency": "scripts/bench_latency.py",
           "bench_serve_concurrency": "scripts/bench_serve_concurrency.py"}


def _run_all(cmds, env=None):
    """Run the commands at once -> {key: (returncode, stdout, stderr)}."""
    procs = {k: subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in cmds.items()}
    out = {}
    for k, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=120)
        out[k] = (proc.returncode, stdout, stderr)
    return out


@pytest.fixture(scope="module")
def jax_options():
    """Each JAX script's options and defaults, its --help dumped in a
    subprocess of its own, the three at once."""
    return _run_all({k: [sys.executable, "-c", DUMP, script]
                     for k, script in SCRIPTS.items()},
                    env=dict(os.environ, JAX_PLATFORMS="cpu"))


def _options(parser):
    return {"/".join(a.option_strings): [a.default, a.choices]
            for a in parser._actions}


@pytest.mark.parametrize("module,added", [
    (bench, {"--platform"}),
    (bench_latency, {"--platform"}),
    (bench_serve_concurrency, set()),
], ids=list(SCRIPTS))
def test_flags_match_jax_script(module, added, jax_options):
    rc, stdout, stderr = jax_options[module.__name__.rsplit(".", 1)[1]]
    assert rc == 0, stderr
    want = json.loads(stdout.splitlines()[-1])
    got = json.loads(json.dumps(_options(module.build_parser())))
    assert {k: v for k, v in got.items() if k not in added} == want
    assert set(got) - set(want) == added
    assert len(want) > 8


# ------------------------------------------------------------ no card

@pytest.fixture(scope="module")
def no_card_runs():
    """``python -m radar_depth_tpu_torch.<entry point>`` with no flags,
    the three at once."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    return _run_all({m: [sys.executable, "-m", f"radar_depth_tpu_torch.{m}"]
                     for m in SCRIPTS})


@pytest.mark.parametrize("module", list(SCRIPTS))
def test_without_card_fails(module, no_card_runs):
    rc, stdout, stderr = no_card_runs[module]
    assert rc != 0
    assert NO_CARD in stderr
    assert not stdout
