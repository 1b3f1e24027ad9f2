"""The whole slice: the port's Predictor (raw batch -> z-buffer -> two-stage
forward -> depth) against the JAX Predictor built from the same variables.

Tolerance atol=2e-4, rtol=1e-3 on the prediction, as in
tests/test_torch_models.py: the preprocessed inputs are bit-identical
(tests/test_torch_preprocess.py), and the forward differs by float32
summation order only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig, ModelConfig, TrainConfig
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu_torch.config import ServeConfig
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor
from tests.test_torch_models import random_jax_variables

H, W, SWEEPS = 64, 96, 3
TOL = dict(atol=2e-4, rtol=1e-3)
CFG = ServeConfig(arch="resnet18_multistage", decoder="upproj", height=H,
                  width=W, num_sweeps=SWEEPS, abs_threshold=8.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=CFG.arch, decoder=CFG.decoder,
                          abs_threshold=CFG.abs_threshold))
    jpred = JaxPredictor(jcfg, None, None)
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = random_jax_variables(jpred.model, (rgb, rgb[..., :1]), seed=7)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    ds = SyntheticNuScenes(8, spec=SampleSpec(height=H, width=W,
                                              num_sweeps=SWEEPS,
                                              lidar_points=2048), seed=3)
    return jpred, state_dict_from_jax_variables(variables), ds


def test_predict_matches_jax(setup):
    """B=3 pads to a tile of 4 in both Predictors and slices back."""
    jpred, sd, ds = setup
    batch = ds.batch(range(3))
    want = jpred.predict(batch)
    got = Predictor(CFG, sd, device="cpu").predict(batch)
    assert got.shape == (3, H, W) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_predict_stream_and_tiling(setup):
    """predict_stream yields what predict gives, batch for batch, and
    max_tile splits a request into pow2 chunks without changing values."""
    _, sd, ds = setup
    pred = Predictor(CFG, sd, device="cpu")
    batches = [ds.batch(range(i, i + 2)) for i in (0, 2, 4)]
    got = list(pred.predict_stream(iter(batches)))
    assert len(got) == 3
    for b, out in zip(batches, got):
        np.testing.assert_array_equal(out, pred.predict(b))
    five = ds.batch(range(5))
    np.testing.assert_allclose(pred.predict(five, max_tile=2),
                               pred.predict(five), **TOL)


def test_predict_blend_picks_a_head_per_sample(setup):
    """blend_tau > 0: each sample's output is one of the two heads."""
    _, sd, ds = setup
    batch = ds.batch(range(2))
    refined = Predictor(CFG, sd, device="cpu")
    p = Predictor(dataclasses.replace(CFG, blend_tau=1.0), sd, device="cpu")
    # every image is darker than tau=1.0, so the blend is the refined head
    np.testing.assert_array_equal(p.predict(batch), refined.predict(batch))


def test_predictor_defaults_to_the_card(setup, monkeypatch):
    """No card and no device="cpu": the Predictor raises, never falls back."""
    _, sd, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(CFG, sd)
