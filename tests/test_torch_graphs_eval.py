"""The eval paths on their per-shape graphs (radar_depth_tpu_torch/graphs.py)
on the CPU, with the stand-in capture of tests/torch_graph_capture.py:
``make_eval_step`` (with a ragged last batch, and under a sparsifier, whose
generator the graph registers), ``make_predict_fn``, the Trainer's
``validate`` and ``validate_splits`` over two epochs, ``Predictor.evaluate``
and the artifact of ``load_serving``, each bit-equal to its eager run under
``graphs.disable_graphs()``. The flagship at 64x96, B=2, float32.

On the CPU the kernels' wrappers run their plain versions and count
nothing, so ``counting_kernels`` makes the wrappers of kernels C and B
count their calls here as they count their launches on the card; a graph's
replay must then add what one eager call counts. The graphed eval step is
also held to the JAX package's eval step on the same numpy-seeded batch and
converted weights, with the tolerance of tests/test_torch_train.py's eager
parity test (sums rtol 1e-4).
"""

import dataclasses
import os
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.train import step as jstep
from radar_depth_tpu_torch import graphs
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    ServeConfig,
    TrainConfig,
)
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor, load_serving
from radar_depth_tpu_torch.models import create_model, init_random
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.train.loop import Trainer
from radar_depth_tpu_torch.train.step import make_eval_step, make_predict_fn
from tests.test_torch_train import (  # noqa: F401  (fixtures)
    _assert_sums,
    _configs,
    _port_model,
    _with_model,
    native_float32_convs,
    setup,
)
from tests.torch_graph_capture import (  # noqa: F401  (fixture)
    Recorder,
    capture_on_cpu,
)

H, W, SWEEPS, B = 64, 96, 2, 2
ARCH = "resnet18_multistage"
SPEC = SampleSpec(height=H, width=W, num_sweeps=SWEEPS)
SITES = 84  # kernel B sites of one flagship eval forward


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def counting_kernels(monkeypatch):
    """Kernel C's and kernel B's wrappers count their calls on the CPU, into
    the counters ``graphs.kernel_counters`` reads."""
    zbuffer, epilogue = (kernels.zbuffer_min_depth_sorted,
                         kernels.batch_norm_relu)

    def zbuffer_min_depth_sorted(*args):
        zbuffer_min_depth_sorted.launches += 1
        return zbuffer(*args)

    def batch_norm_relu(*args, **kw):
        kernels.scale_bias_relu.launches += 1
        return epilogue(*args, **kw)

    zbuffer_min_depth_sorted.launches = 0
    monkeypatch.setattr(kernels, "zbuffer_min_depth_sorted",
                        zbuffer_min_depth_sorted)
    monkeypatch.setattr(kernels, "batch_norm_relu", batch_norm_relu)
    monkeypatch.setattr(kernels.scale_bias_relu, "launches", 0)


def _counts():
    return {k: getattr(kernels, k).launches
            for k in ("zbuffer_min_depth_sorted", "scale_bias_relu")}


def _batch(seed, n=B):
    return SyntheticNuScenes(n, spec=SPEC, seed=seed).batch(range(n))


def _cfg(**data):
    return TrainConfig(data=DataConfig(height=H, width=W, num_sweeps=SWEEPS,
                                       **data),
                       model=ModelConfig(arch=ARCH, decoder="upproj",
                                         blend_tau=0.3),
                       batch_size=B)


@pytest.fixture(scope="module")
def model():
    m, spec = create_model(ARCH, device="cpu", output_size=(H, W))
    init_random(m, 0)
    return m, spec


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("sparsifier", ["none", "uar"])
def test_eval_step_graph_equals_eager(capture_on_cpu, counting_kernels,
                                      model, sparsifier):
    """Full batches and ragged ones (two keys), bit-equal sums each call,
    one eager call's launches per replay, the sums of a replay left as they
    were by the later replays. Under a sparsifier the graph registers the step's
    generator, seeded again each call (the same draws every call)."""
    m, spec = model
    cfg = _cfg(sparsifier=sparsifier)
    graphed = make_eval_step(m, spec, cfg)
    graphed.graphs.capture = Recorder()
    eager = make_eval_step(m, spec, cfg)
    batches = [_batch(0), _batch(1), _batch(2), _batch(3, 1), _batch(4, 1),
               _batch(5)]
    got, want, counts = [], [], []
    for b in batches:
        before = _counts()
        got.append(graphed(b))
        counts.append({k: n - before[k] for k, n in _counts().items()})
        before = _counts()
        with graphs.disable_graphs():
            want.append(eager(b))
        assert {k: n - before[k] for k, n in _counts().items()} == counts[-1]
    # read after every call: each call's sums survived the later replays
    assert all(_equal(g, w) for g, w in zip(got, want))
    zbuffer = 0 if sparsifier == "uar" else 1
    assert counts == [{"zbuffer_min_depth_sorted": zbuffer,
                       "scale_bias_relu": SITES}] * len(batches)
    assert graphed.graphs.stats == {"eager": 2, "captures": 2, "replays": 4}
    assert graphed.graphs.capture.calls == [int(sparsifier == "uar")] * 2
    assert len(graphed.graphs._graphs) == 2


def test_graphed_eval_step_matches_jax(capture_on_cpu, setup):
    """The third call at a key (a replay) against the JAX eval step, with
    the tolerance of tests/test_torch_train.py::test_eval_step_matches_jax
    (sums rtol 1e-4)."""
    jmodel, jspec, variables, ds = setup
    jcfg, cfg = (_with_model(c, blend_tau=0.3) for c in _configs())
    batch = ds.batch(range(2, 4))
    want = jax.jit(jstep.make_eval_step(jmodel, jspec, jcfg))(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()})
    m, spec = _port_model(variables)
    step = make_eval_step(m, spec, cfg)
    step.graphs.capture = Recorder()
    for _ in range(3):
        got = step(batch)
    assert step.graphs.stats == {"eager": 1, "captures": 1, "replays": 2}
    _assert_sums(got, want)


def test_predict_fn_graph_equals_eager(capture_on_cpu, counting_kernels,
                                       model):
    """The panels' B=1 forward: bit-equal outputs, each call's copies left
    as they were by the next calls, the launches of eager calls."""
    m, spec = model
    cfg = _cfg()
    graphed, eager = make_predict_fn(m, spec, cfg), make_predict_fn(m, spec,
                                                                    cfg)
    graphed.graphs.capture = Recorder()
    batches = [_batch(s, 1) for s in range(4)]
    got = [graphed(b) for b in batches]
    launches = _counts()
    with graphs.disable_graphs():
        want = [eager(b) for b in batches]
    assert all(_equal(g, w) for g, w in zip(got, want))
    assert {k: 2 * n for k, n in launches.items()} == _counts()
    assert launches == {"zbuffer_min_depth_sorted": 4,
                        "scale_bias_relu": 4 * SITES}
    assert graphed.graphs.stats == {"eager": 1, "captures": 1, "replays": 3}
    assert set(got[0]) == {"rgb", "radar", "target", "pred"}


def _trainer(tmp_path, name):
    cfg = dataclasses.replace(
        _cfg(num_train=4, num_val=5), eval_batch_size=2, platform="cpu",
        val_viz_every=1, output_dir=str(tmp_path / name))
    return Trainer(cfg)


def test_trainer_validate_graph_equals_eager(tmp_path, capture_on_cpu):
    """Two epochs of ``validate`` (5 samples at eval batch 2: a ragged last
    batch) and a ``validate_splits``, graphed and eager: equal metrics and
    equal comparison panels (``make_predict_fn``'s graph)."""
    runs = {}
    for mode in ("graph", "eager"):
        trainer = _trainer(tmp_path, mode)
        try:
            if mode == "graph":
                trainer._eval_step.graphs.capture = Recorder()
                trainer._predict.graphs.capture = Recorder()
            with (graphs.disable_graphs() if mode == "eager"
                  else nullcontext()):
                epochs = [trainer.validate(epoch) for epoch in range(2)]
                splits = trainer.validate_splits(1)
            panels = [open(os.path.join(trainer.cfg.output_dir,
                                        f"comparison_epoch{e}.png"),
                           "rb").read() for e in range(2)]
            runs[mode] = (epochs, splits, panels,
                          dict(trainer._eval_step.graphs.stats),
                          dict(trainer._predict.graphs.stats))
        finally:
            trainer.close()
    timing = ("data_time", "gpu_time")
    (g_epochs, g_splits, g_panels, g_stats, p_stats), (e_epochs, e_splits,
                                                       e_panels, *_) = (
        runs["graph"], runs["eager"])
    for got, want in zip(g_epochs + list(g_splits.values()),
                         e_epochs + list(e_splits.values())):
        assert {k: v for k, v in got.items() if k not in timing} == {
            k: v for k, v in want.items() if k not in timing}
    assert sorted(g_splits) == sorted(e_splits) == ["day", "night"]
    assert g_panels == e_panels
    # epoch 0: B=2 eager, then captured; B=1 eager; epoch 1 replays B=2
    # and captures B=1; the splits replay or capture their own batches
    assert g_stats["captures"] >= 2 and g_stats["replays"] >= 4
    # three panel rows an epoch, one sample each
    assert p_stats == {"eager": 1, "captures": 1, "replays": 5}


@pytest.fixture(scope="module")
def served_weights(model):
    return model[0].state_dict()


def _serve_cfg():
    return ServeConfig(arch=ARCH, decoder="upproj", height=H, width=W,
                       num_sweeps=SWEEPS, blend_tau=0.3)


def test_predictor_evaluate_graph_equals_eager(capture_on_cpu,
                                               served_weights):
    """``evaluate`` through ``infer``'s graph of the batch's shape, the
    infer calls between evaluations replaying the same graph: equal
    metrics and maps."""
    graphed = Predictor(_serve_cfg(), served_weights, device="cpu")
    graphed.graphs.capture = Recorder()
    eager = Predictor(_serve_cfg(), served_weights, device="cpu")
    eager.graphs = None
    for seed in range(3):
        b = _batch(seed)
        assert graphed.evaluate(b) == eager.evaluate(b)
        assert torch.equal(graphed.infer(_batch(seed + 10)),
                           eager.infer(_batch(seed + 10)))
    assert graphed.graphs.stats == {"eager": 1, "captures": 1, "replays": 5}
    assert graphed.evaluate(_batch(1, 1)) == eager.evaluate(_batch(1, 1))


def test_predictor_evaluate_on_the_graph_fills_keep(capture_on_cpu,
                                                    served_weights):
    """``keep`` gets what ``evaluate``'s replay prepared and computed, as
    the eager ``evaluate`` leaves it, and a later replay at the same shape
    without ``keep`` leaves it as it was."""
    graphed = Predictor(_serve_cfg(), served_weights, device="cpu")
    graphed.graphs.capture = Recorder()
    eager = Predictor(_serve_cfg(), served_weights, device="cpu")
    eager.graphs = None
    graphed.infer(_batch(5)), graphed.infer(_batch(6))  # eager, captured
    graphed.keep, eager.keep = keep, want = {}, {}
    assert graphed.evaluate(_batch(0)) == eager.evaluate(_batch(0))
    assert graphed.graphs.stats["replays"] == 2
    graphed.keep = None
    graphed.infer(_batch(7))
    assert torch.equal(keep["prepared"]["target"], want["prepared"]["target"])
    assert torch.equal(keep["out"][1], want["out"][1])


def test_artifact_graph_equals_eager(tmp_path, capture_on_cpu,
                                     served_weights):
    """``load_serving``'s graph over the exported module: bit-equal to the
    eager module and to ``Predictor.predict``; torch.export's input-check
    hooks are off the module, whose inputs ``serve`` checks."""
    pred = Predictor(_serve_cfg(), served_weights, device="cpu")
    pred.graphs = None
    path = str(tmp_path / "flagship.pt2")
    pred.export_serving(path, B)
    serve = load_serving(path, device="cpu")
    serve.graphs.capture = Recorder()
    batches = [_batch(s) for s in range(3)]
    got = [serve(b) for b in batches]
    assert serve.graphs.stats == {"eager": 1, "captures": 1, "replays": 2}
    with graphs.disable_graphs():
        want = [serve(b) for b in batches]
    for g, w, b in zip(got, want, batches):
        assert np.array_equal(g, w) and np.array_equal(g, pred.predict(b))
    assert got[0].shape == (B, H, W)
    with pytest.raises(ValueError, match="the artifact takes"):
        serve(_batch(0, 1))
