"""The port's data, geometry and eval preprocessing against the JAX package,
on the same seeded synthetic batch: the radar z-buffer map, rgb and target
must be exactly equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radar_depth_tpu.data.schema import SampleSpec as JaxSampleSpec
from radar_depth_tpu.data.synthetic import SyntheticNuScenes as JaxSynthetic
from radar_depth_tpu.ops import geometry as jgeo
from radar_depth_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from radar_depth_tpu.ops.preprocess import pack_model_inputs as jax_pack
from radar_depth_tpu.ops.preprocess import prepare_eval_batch as jax_prepare
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.ops import geometry as tgeo
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
)

SPEC = dict(height=64, width=96, num_sweeps=3, lidar_points=2048)


@pytest.fixture(scope="module")
def batch():
    return SyntheticNuScenes(3, spec=SampleSpec(**SPEC), seed=0).batch(range(3))


def test_synthetic_matches_jax(batch):
    want = JaxSynthetic(3, spec=JaxSampleSpec(**SPEC), seed=0).batch(range(3))
    assert set(batch) == set(want)
    for k in want:
        assert batch[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)


@pytest.mark.parametrize("height_extension", [0, 2])
def test_prepare_eval_batch_matches_jax(batch, height_extension):
    want = jax_prepare({k: jnp.asarray(v) for k, v in batch.items()},
                       JaxPreprocessConfig(spec=JaxSampleSpec(**SPEC),
                                           height_extension=height_extension))
    got = prepare_eval_batch(batch, PreprocessConfig(
        spec=SampleSpec(**SPEC), height_extension=height_extension),
        device="cpu")
    for k in ("radar", "rgb", "target"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert (got["radar"] > 0).sum() > 10  # the map is not trivially empty


def test_geometry_matches_jax():
    """Transform chains and projection: the FMA-chain products are
    bit-exact; quaternion normalisation within float32 rounding."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 4)).astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    want_T = np.array(jgeo.se3_from_quat_trans(jnp.asarray(q), jnp.asarray(t)))
    got_T = tgeo.se3_from_quat_trans(torch.from_numpy(q), torch.from_numpy(t))
    np.testing.assert_allclose(got_T.numpy(), want_T, atol=1e-6, rtol=0)
    T = [want_T[i] for i in range(4)]
    want = np.asarray(jgeo.camera_chain(*map(jnp.asarray, T)))
    got = tgeo.camera_chain(*map(torch.from_numpy, T))
    np.testing.assert_array_equal(got.numpy(), want)
    pts = rng.uniform(-20, 40, size=(2, 50, 3)).astype(np.float32)
    K = np.array([[640, 0, 48], [0, 640, 32], [0, 0, 1]], np.float32)
    want_uv, want_z = jgeo.project_points(
        jgeo.se3_apply(jnp.asarray(want_T[:2]), jnp.asarray(pts)),
        jnp.asarray(K))
    got_uv, got_z = tgeo.project_points(
        tgeo.se3_apply(torch.from_numpy(want_T[:2]), torch.from_numpy(pts)),
        torch.from_numpy(K))
    np.testing.assert_array_equal(got_uv.numpy(), np.asarray(want_uv))
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))


def test_pack_model_inputs_matches_jax():
    """Late fusion packs (rgb, radar), the single-branch kinds (rgb,),
    (concat(rgb, radar),) or (radar,) by modality, as in JAX; an unknown
    modality raises."""
    rng = np.random.default_rng(1)
    prepared = {"rgb": rng.uniform(size=(2, 4, 6, 3)).astype(np.float32),
                "radar": rng.uniform(size=(2, 4, 6, 1)).astype(np.float32)}
    ported = {k: torch.from_numpy(v) for k, v in prepared.items()}
    for kind, modality, n in (("late", "rgbd", 2), ("single", "rgb", 1),
                              ("single", "rgbd", 1), ("single", "d", 1)):
        want = jax_pack({k: jnp.asarray(v) for k, v in prepared.items()},
                        kind, modality)
        got = pack_model_inputs(ported, kind, modality)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="modality"):
        pack_model_inputs(ported, "single", "rgbdd")


def test_prepare_eval_batch_defaults_to_the_card(batch, monkeypatch):
    """With no card and no explicit device="cpu" the entry point raises; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_eval_batch(batch, PreprocessConfig(spec=SampleSpec(**SPEC)))
