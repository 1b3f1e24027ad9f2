"""The port's train-time augmentation and train preprocessing against the JAX
package's, with the augmentation parameters drawn by JAX's
sample_affine_params and handed to the port.

The reference is the JAX package's jitted graph, which its train step runs:
XLA's CPU compiler fuses a product into the add that follows it in places,
and the port rounds those products the same way (radar_depth_tpu_torch/
ops/augment.py). Radar maps, both raster backends, and the LiDAR targets of
both gt_augment modes come out bit-identical; rgb within atol 1e-6 (the
bilinear blend and the jitter's means are float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.data.schema import SampleSpec as JaxSampleSpec
from radar_depth_tpu.ops import augment as ja
from radar_depth_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from radar_depth_tpu.ops.preprocess import prepare_train_batch as jax_prepare
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.ops import augment as ta
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    prepare_train_batch,
)

SPEC = dict(height=64, width=96, num_sweeps=3, lidar_points=2048)
H, W = SPEC["height"], SPEC["width"]
RGB_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_params(seed, batch):
    return tuple(np.asarray(p) for p in ja.sample_affine_params(
        jax.random.PRNGKey(seed), ja.AugmentConfig(), batch))


@pytest.fixture(scope="module")
def batch():
    return SyntheticNuScenes(4, spec=SampleSpec(**SPEC), seed=2).batch(range(4))


def test_make_affine_matches_jax_where_libm_rounds_correctly():
    """Bit-exact affines, except where XLA's float32 sin or cos (glibc's
    sinf, cosf) is not the correctly rounded value the port takes (float64,
    rounded once): there the entries built from it differ in the last
    digits. Over 4096 draws that is a few samples in a thousand."""
    scale, angle, flip, _ = _jax_params(0, 4096)
    want = np.asarray(jax.jit(
        lambda s, a, f: ja.make_affine(s, a, f, H, W))(scale, angle, flip))
    got = ta.make_affine(_t(scale), _t(angle), _t(flip), H, W).numpy()
    a64 = angle.astype(np.float64)
    off = ((np.asarray(jnp.sin(angle)) != np.sin(a64).astype(np.float32))
           | (np.asarray(jnp.cos(angle)) != np.cos(a64).astype(np.float32)))
    differs = (got != want).reshape(len(angle), 6).any(axis=1)
    assert not (differs & ~off).any()
    assert off.sum() < 0.01 * len(angle)
    np.testing.assert_array_equal(got[~off], want[~off])
    np.testing.assert_allclose(got[off], want[off], rtol=1e-6, atol=1e-6)


def test_inverse_and_point_affine_match_jax():
    """invert_affine with the products fused as in XLA's jitted graph, and
    apply_affine_uv as the CPU dot's fused chain: bit-exact."""
    scale, angle, flip, _ = _jax_params(1, 512)
    A = np.asarray(jax.jit(
        lambda s, a, f: ja.make_affine(s, a, f, H, W))(scale, angle, flip))
    np.testing.assert_array_equal(
        ta.invert_affine(_t(A)).numpy(),
        np.asarray(jax.jit(ja.invert_affine)(jnp.asarray(A))))
    uv = np.random.default_rng(1).uniform(-10, 110, (512, 300, 2))
    uv = uv.astype(np.float32)
    np.testing.assert_array_equal(
        ta.apply_affine_uv(_t(A), _t(uv)).numpy(),
        np.asarray(jax.jit(ja.apply_affine_uv)(jnp.asarray(A),
                                               jnp.asarray(uv))))


@pytest.mark.parametrize("gt_augment,backend", [
    ("warp", "sorted"), ("warp", "scatter"), ("rerasterize", "sorted"),
    ("rerasterize", "scatter")])
def test_prepare_train_batch_matches_jax(batch, gt_augment, backend):
    """The augmented radar map and LiDAR target exactly, rgb within 1e-6,
    against the JAX package's jitted prepare_train_batch."""
    jcfg = JaxPreprocessConfig(spec=JaxSampleSpec(**SPEC),
                               gt_augment=gt_augment, raster_backend=backend)
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda b, k: jax_prepare(b, jcfg, k))(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    params = tuple(np.asarray(p) for p in ja.sample_affine_params(
        key, ja.AugmentConfig(), 4))
    got = prepare_train_batch(batch, PreprocessConfig(
        spec=SampleSpec(**SPEC), gt_augment=gt_augment,
        raster_backend=backend), aug_params=params, device="cpu")
    for k in ("radar", "target"):
        assert got[k].shape == (4, H, W, 1) and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=RGB_ATOL, rtol=0)
    assert (got["radar"] > 0).sum() > 10 and (got["target"] > 0).sum() > 100


@pytest.mark.parametrize("gt_augment", ["warp", "rerasterize"])
def test_prepare_train_batch_without_augmentation_matches_jax(batch,
                                                              gt_augment):
    """augment.enabled=False: the eval maps, and the LiDAR target either as
    stored or z-buffered again from the points. rgb within one ulp: the
    jitted graph multiplies by 1/255 where the port divides by 255, as the
    JAX package's own eager eval path does."""
    off = ja.AugmentConfig(enabled=False)
    jcfg = JaxPreprocessConfig(spec=JaxSampleSpec(**SPEC), augment=off,
                               gt_augment=gt_augment)
    want = jax.jit(lambda b: jax_prepare(b, jcfg, jax.random.PRNGKey(0)))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = prepare_train_batch(batch, PreprocessConfig(
        spec=SampleSpec(**SPEC), augment=ta.AugmentConfig(enabled=False),
        gt_augment=gt_augment), device="cpu")
    for k in ("radar", "target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=RGB_ATOL, rtol=0)


def test_color_jitter_and_image_warp_match_jax():
    """Identity affine: the warp returns the image; jitter within 1e-6 of
    JAX's (means summed in another order)."""
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    ident = np.tile(np.asarray([[1, 0, 0], [0, 1, 0]], np.float32), (2, 1, 1))
    np.testing.assert_array_equal(
        ta.warp_images_bilinear(_t(img), _t(ident)).numpy(), img)
    factors = rng.uniform(0.6, 1.4, size=(2, 3)).astype(np.float32)
    want = np.asarray(ja.color_jitter(jnp.asarray(img), jnp.asarray(factors)))
    got = ta.color_jitter(_t(img), _t(factors)).numpy()
    np.testing.assert_allclose(got, want, atol=RGB_ATOL, rtol=0)
    assert got.min() >= 0 and got.max() <= 1


def test_sample_affine_params_ranges_and_generator():
    """The port's own draws: shapes, dtypes and ranges of the config, the
    same stream for the same seed."""
    cfg = ta.AugmentConfig()
    draw = lambda: ta.sample_affine_params(
        torch.Generator().manual_seed(5), cfg, 256)
    scale, angle, flip, jitter = draw()
    assert scale.shape == angle.shape == flip.shape == (256,)
    assert jitter.shape == (256, 3) and flip.dtype == torch.bool
    assert 1.0 <= scale.min() and scale.max() <= 1.5
    assert angle.abs().max() <= 5.0 * np.pi / 180
    assert 0.6 <= jitter.min() and jitter.max() <= 1.4
    assert 0.3 < flip.float().mean() < 0.7
    for a, b in zip(draw(), (scale, angle, flip, jitter)):
        assert torch.equal(a, b)


def test_prepare_train_batch_needs_params_or_generator(batch):
    cfg = PreprocessConfig(spec=SampleSpec(**SPEC))
    with pytest.raises(ValueError, match="generator"):
        prepare_train_batch(batch, cfg, device="cpu")
    out = prepare_train_batch(batch, cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    assert out["rgb"].shape == (4, H, W, 3)
    with pytest.raises(ValueError, match="raster_backend"):
        PreprocessConfig(raster_backend="dense")
    with pytest.raises(ValueError, match="gt_augment"):
        PreprocessConfig(gt_augment="nearest")
