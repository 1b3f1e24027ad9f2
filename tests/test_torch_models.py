"""The port's models against the JAX package's, with the same variables
carried across by radar_depth_tpu_torch.convert.

Variables are drawn with numpy from a seed into the shapes of the flax tree
(jax.eval_shape, no compile), BN statistics included, so the batch_stats
mapping is exercised. Both frameworks run float32 (cuDNN/TF32 play no part on
the CPU). Tolerance atol=2e-4, rtol=1e-3, as tests/test_parity_torch.py:
the two frameworks sum the convolutions in different orders, and float32
rounding over two ResNet-18 stages and a decoder stays well inside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.models.fusion import blend_by_brightness as jax_blend
from radar_depth_tpu.models.fusion import (
    filter_radar_by_prediction as jax_filter,
)
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.models import (
    blend_by_brightness,
    create_model,
    filter_radar_by_prediction,
)
from radar_depth_tpu_torch.models.layers import UnpoolConv

OUT = (64, 96)
TOL = dict(atol=2e-4, rtol=1e-3)


def random_jax_variables(model, inputs, seed):
    """{params, batch_stats} of ``model`` as numpy arrays drawn from
    ``seed``: He-normal kernels, BN scale and var in [0.5, 1.5), bias and
    mean N(0, 0.1). The head conv is scaled so predictions are depth-sized
    (tens of meters), which keeps the absolute tolerance meaningful."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *inputs, train=False))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(s.shape[:3]))
            if path[-2].key == "conv3":
                std *= 0.05
            return (rng.normal(size=s.shape) * std).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(batch, *OUT, 3)).astype(np.float32)
    radar = ((rng.uniform(size=(batch, *OUT, 1)) > 0.97)
             * rng.uniform(3, 70, size=(batch, *OUT, 1))).astype(np.float32)
    return rgb, radar


def _port(arch, variables, **kw):
    model, _ = create_model(arch, device="cpu", output_size=OUT, **kw)
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    return model


@pytest.fixture(scope="module")
def multistage():
    rgb, radar = _inputs()
    jmodel, _ = jax_create_model("resnet18_multistage", decoder="upproj",
                                 output_size=OUT)
    variables = random_jax_variables(
        jmodel, (jnp.asarray(rgb), jnp.asarray(radar)), seed=1)
    return rgb, radar, variables


@pytest.mark.parametrize("mode,abs_t,rel_t", [("abs", 8.0, 0.15),
                                              ("rel", 2.0, 0.5),
                                              ("or", 4.0, 0.3)])
def test_multistage_matches_jax(multistage, mode, abs_t, rel_t):
    """Both heads of resnet18_multistage/upproj, each radar filter mode,
    and the brightness blend over the two heads."""
    rgb, radar, variables = multistage
    kw = dict(filter_mode=mode, abs_threshold=abs_t, rel_threshold=rel_t)
    jmodel, _ = jax_create_model("resnet18_multistage", decoder="upproj",
                                 output_size=OUT, **kw)
    want_c, want_r = map(np.asarray, jmodel.apply(
        variables, jnp.asarray(rgb), jnp.asarray(radar), train=False))
    model = _port("resnet18_multistage", variables, **kw)
    with torch.inference_mode():
        got_c, got_r = model(torch.from_numpy(rgb), torch.from_numpy(radar))
    assert got_c.shape == (2, *OUT, 1) and got_c.dtype == torch.float32
    np.testing.assert_allclose(got_c.numpy(), want_c, **TOL)
    np.testing.assert_allclose(got_r.numpy(), want_r, **TOL)
    # the filter kept some returns and dropped some: stage 2 saw a real input
    kept = np.asarray(jax_filter(jnp.asarray(radar), jnp.asarray(want_c),
                                 abs_t, rel_t, mode))
    assert 0 < (kept > 0).sum() < (radar > 0).sum()

    tau = float(rgb.mean(axis=(1, 2, 3)).mean())  # one dark, one bright
    want_b = np.asarray(jax_blend(jnp.asarray(want_c), jnp.asarray(want_r),
                                  jnp.asarray(rgb), tau))
    got_b = blend_by_brightness(got_c, got_r, torch.from_numpy(rgb), tau)
    np.testing.assert_allclose(got_b.numpy(), want_b, **TOL)


def test_latefusion_matches_jax():
    rgb, radar = _inputs(seed=2)
    jmodel, _ = jax_create_model("resnet18_latefusion", decoder="upproj",
                                 output_size=OUT)
    variables = random_jax_variables(
        jmodel, (jnp.asarray(rgb), jnp.asarray(radar)), seed=3)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(rgb),
                                   jnp.asarray(radar), train=False))
    with torch.inference_mode():
        got = _port("resnet18_latefusion", variables)(
            torch.from_numpy(rgb), torch.from_numpy(radar))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["abs", "rel", "or"])
def test_filter_and_blend_match_jax(mode):
    """The elementwise stage-1 -> stage-2 filter and the blend, exactly."""
    rng = np.random.default_rng(4)
    radar = ((rng.uniform(size=(3, 8, 9, 1)) > 0.5)
             * rng.uniform(1, 60, size=(3, 8, 9, 1))).astype(np.float32)
    pred = rng.uniform(-5, 60, size=radar.shape).astype(np.float32)
    want = np.asarray(jax_filter(jnp.asarray(radar), jnp.asarray(pred), 5.0,
                                 0.2, mode))
    got = filter_radar_by_prediction(torch.from_numpy(radar),
                                     torch.from_numpy(pred), 5.0, 0.2, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    rgb = np.stack([np.full((8, 9, 3), v, np.float32) for v in (0.1, 0.5, 0.9)])
    want_b = np.asarray(jax_blend(jnp.asarray(pred), jnp.asarray(radar),
                                  jnp.asarray(rgb), 0.4))
    got_b = blend_by_brightness(torch.from_numpy(pred),
                                torch.from_numpy(radar),
                                torch.from_numpy(rgb), 0.4)
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_unpool_conv_is_zero_insert_then_conv():
    """The transposed-conv form of unpool + 5x5 conv equals the explicit
    zero-insertion unpool followed by the conv (upstream Unpool)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 5, 7, generator=g)
    layer = UnpoolConv(6, 4, 5)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=g))
        up = torch.zeros(2, 6, 5, 2, 7, 2)
        up[:, :, :, 0, :, 0] = x
        want = F.conv2d(up.reshape(2, 6, 10, 14), layer.weight, padding=2)
        got = layer(x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_convert_rejects_mismatched_trees(multistage):
    _, _, variables = multistage
    model, _ = create_model("resnet18_multistage", device="cpu",
                            output_size=OUT)
    like = model.state_dict()
    bad = {"params": dict(variables["params"]),
           "batch_stats": variables["batch_stats"]}
    del bad["params"]["stage2"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax_variables(bad, like=like)
    bad["params"] = dict(variables["params"], extra={"kernel": np.zeros(
        (1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_jax_variables(bad, like=like)
    small = dict(like)
    small["stage1.conv3.weight"] = torch.zeros(1, 8, 3, 3)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax_variables(variables, like=small)
    with pytest.raises(KeyError, match="unknown arch"):
        create_model("resnet101_multistage", device="cpu")
