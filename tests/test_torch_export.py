"""The port's serving artifact (inference.py: Predictor.export_serving,
load_serving) on the CPU: the flagship's whole raw-batch -> depth path
exported with torch.export at B=2, 64x96, saved, loaded and run, against
Predictor.predict (exactly: the same operators on the same inputs) and
against the JAX Predictor on the same converted variables (atol 2e-4, rtol
1e-3, as tests/test_torch_inference.py).

Each artifact holds the float32 weights (~205 MB) and is written under
tmp_path.
"""

import dataclasses
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig, ModelConfig, TrainConfig
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu_torch.config import ServeConfig
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import (
    SERVING_META,
    Predictor,
    load_serving,
)
from tests.test_torch_models import random_jax_variables

H, W, SWEEPS, B = 64, 96, 3, 2
TOL = dict(atol=2e-4, rtol=1e-3)
CFG = ServeConfig(arch="resnet18_multistage", decoder="upproj", height=H,
                  width=W, num_sweeps=SWEEPS, abs_threshold=8.0)
ZBUFFER_OP = {"sorted": "rdt.zbuffer_min_depth_sorted.default",
              "scatter": "rdt.zbuffer_min_depth.default"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    """Converted variables, a B=2 batch (the schema's full LiDAR buffer, as
    the artifact takes every schema array) and the JAX prediction on it."""
    jcfg = TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=CFG.arch, decoder=CFG.decoder,
                          abs_threshold=CFG.abs_threshold))
    jpred = JaxPredictor(jcfg, None, None)
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = random_jax_variables(jpred.model, (rgb, rgb[..., :1]), seed=7)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    batch = SyntheticNuScenes(B, spec=SampleSpec(height=H, width=W,
                                                 num_sweeps=SWEEPS),
                              seed=3).batch(range(B))
    return state_dict_from_jax_variables(variables), batch, \
        jpred.predict(batch)


@pytest.fixture(scope="module")
def artifacts(setup, tmp_path_factory):
    """{backend: (path, bytes, Predictor)} for both z-buffer backends."""
    sd, _, _ = setup
    root = tmp_path_factory.mktemp("export")
    out = {}
    for backend in ("sorted", "scatter"):
        pred = Predictor(dataclasses.replace(CFG, raster_backend=backend), sd,
                         device="cpu")
        path = str(root / f"{backend}.pt2")
        out[backend] = (path, pred.export_serving(path, B), pred)
    return out


@pytest.mark.parametrize("backend", ["sorted", "scatter"])
def test_artifact_equals_predict_and_jax(setup, artifacts, backend):
    _, batch, want_jax = setup
    path, nbytes, pred = artifacts[backend]
    assert nbytes > 100e6  # the float32 weights are baked in
    got = load_serving(path, device="cpu")(batch)
    assert got.shape == (B, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, pred.predict(batch))
    np.testing.assert_allclose(got, want_jax, **TOL)


@pytest.mark.parametrize("backend", ["sorted", "scatter"])
def test_graph_holds_every_kernel_site(artifacts, backend):
    """84 kernel-B sites (the flagship's eval-mode BN->ReLU), each one
    ``rdt.batch_norm_relu`` node fed by the BN's own lifted parameters and
    buffers (the fold is inside the kernel: no ``rsqrt`` in front of it),
    and one z-buffer node of the backend's kernel, none of the other. The
    only ``rsqrt`` nodes are the 22 eval BNs without a ReLU (106 BNs in
    all), which stay plain PyTorch."""
    nodes = [n for n in torch.export.load(artifacts[backend][0]).graph.nodes
             if n.op == "call_function"]
    targets = [str(n.target) for n in nodes]
    assert targets.count("rdt.batch_norm_relu.default") == 84
    assert targets.count("rdt.scale_bias_relu.default") == 0
    assert targets.count("aten.rsqrt.default") == 106 - 84
    for n in nodes:
        if str(n.target) == "rdt.batch_norm_relu.default":
            assert all(a.op == "placeholder" for a in n.args[1:5])
    for b, op in ZBUFFER_OP.items():
        assert targets.count(op) == (1 if b == backend else 0)


def test_wrong_batch_raises(setup, artifacts):
    """The batch size is fixed: another one raises, never retraces."""
    _, batch, _ = setup
    serve = load_serving(artifacts["sorted"][0], device="cpu")
    three = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    with pytest.raises(ValueError, match="batch size 2"):
        serve(three)
    with pytest.raises(KeyError, match="keys"):
        serve({k: v for k, v in batch.items() if k != "intrinsics"})


def test_device_rules(artifacts, tmp_path, monkeypatch):
    """An artifact runs only on the kind of device it was exported on, and
    device=None means the card: without one, load_serving raises."""
    path = artifacts["sorted"][0]
    moved = str(tmp_path / "card.pt2")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(moved, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith(SERVING_META):
                meta = json.loads(data)
                assert meta["device"] == "cpu" and meta["batch_size"] == B
                data = json.dumps(dict(meta, device="cuda")).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        load_serving(moved, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving(path)
