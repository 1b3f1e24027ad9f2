"""The rest of the model zoo against the JAX package: every arch family and
decoder kind in eval mode, with the same variables carried across by
radar_depth_tpu_torch.convert (random variables drawn as in
tests/test_torch_models.py, tolerance atol=2e-4, rtol=1e-3 for the same
reason); the transposed conv and the Bottleneck alone, exact to float32
rounding; kernel B's sites per forward counted from the module structure;
and the single-branch Predictor against the JAX one.

64x96, B=2, float32, oneDNN convolutions off (their float32 sums lose about
two digits against the native ones, as TF32 would on the card).
resnet50_multistage is not run against JAX here: four ResNet-50 encoders
under JAX's CPU compiler cost more than they test; chip_smoke.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig as JaxDataConfig
from radar_depth_tpu.config import ModelConfig as JaxModelConfig
from radar_depth_tpu.config import TrainConfig as JaxTrainConfig
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu.models import ARCH_REGISTRY as JAX_REGISTRY
from radar_depth_tpu.models import DECODER_KINDS as JAX_DECODERS
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.models.layers import TorchConvTranspose
from radar_depth_tpu.models.resnet import Bottleneck as JaxBottleneck
from radar_depth_tpu.ops.preprocess import pack_model_inputs as jax_pack
from radar_depth_tpu_torch.config import ServeConfig
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.models import (
    ARCH_REGISTRY,
    DECODER_KINDS,
    MODALITY_CHANNELS,
    create_model,
    init_random,
)
from radar_depth_tpu_torch.models.layers import ConvTranspose
from radar_depth_tpu_torch.models.resnet import Bottleneck
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.preprocess import pack_model_inputs
from tests.test_torch_models import OUT, TOL, _inputs, random_jax_variables

EXACT = dict(atol=1e-5, rtol=1e-5)  # float32 rounding of reordered sums

# (arch, decoder, create_model kwargs)
FORWARD_CASES = [
    ("resnet18", "upproj", dict(modality="rgb")),
    ("resnet18", "upproj", dict(modality="rgbd")),
    ("resnet18", "upproj", dict(modality="d")),
    ("resnet34_latefusion", "upproj", {}),
    ("resnet50", "upproj", dict(modality="rgbd")),
    ("resnet18_latefusion", "deconv2", {}),
    ("resnet18_latefusion", "deconv3", {}),
    ("resnet18_latefusion", "upconv", {}),
    ("resnet18_multistage", "upproj", dict(stage2_coarse=True,
                                           abs_threshold=8.0)),
    ("resnet18_multistage_uncertainty", "upproj", dict(abs_threshold=8.0)),
]


@pytest.fixture(autouse=True)
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _case_id(case):
    arch, dec, kw = case
    return "-".join([arch, dec] + [f"{k}={v}" for k, v in kw.items()
                                   if k != "abs_threshold"])


@pytest.mark.parametrize("case", FORWARD_CASES,
                         ids=[_case_id(c) for c in FORWARD_CASES])
def test_forward_matches_jax(case):
    arch, decoder, kw = case
    rgb, radar = _inputs(seed=5)
    prepared = {"rgb": rgb, "radar": radar}
    spec = ARCH_REGISTRY[arch]
    modality = kw.get("modality", "rgbd")
    jin = jax_pack({k: jnp.asarray(v) for k, v in prepared.items()},
                   spec.input_kind, modality)
    jmodel, jspec = jax_create_model(arch, decoder=decoder, output_size=OUT,
                                     **kw)
    assert jspec.input_kind == spec.input_kind
    variables = random_jax_variables(jmodel, jin, seed=6)
    want = jmodel.apply(variables, *jin, train=False)
    model, _ = create_model(arch, device="cpu", decoder=decoder,
                            output_size=OUT, **kw)
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    with torch.inference_mode():
        got = model(*pack_model_inputs(
            {k: torch.from_numpy(v) for k, v in prepared.items()},
            spec.input_kind, modality))
    if not spec.multistage:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    if spec.multistage:  # stage 2 saw a filtered input, not all or nothing
        coarse = np.asarray(want[0])
        kept = (radar > 0) & (np.abs(radar - coarse) < kw["abs_threshold"])
        assert 0 < kept.sum() < (radar > 0).sum()


@pytest.mark.parametrize("k,padding,output_padding",
                         [(2, 0, 0), (3, 1, 1), (4, 1, 0), (3, 0, 1)])
def test_conv_transpose_matches_jax(k, padding, output_padding):
    """torch's conv_transpose2d with the converted (O,I,k,k) weight swapped
    to (I,O,k,k) and not flipped is the JAX module's flipped conv over the
    dilated input; deconv2 (k=2, p=0, op=0) and deconv3 (k=3, p=1, op=1)
    double the size."""
    rng = np.random.default_rng(k * 10 + padding)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    jm = TorchConvTranspose(4, k, stride=2, padding=padding,
                            output_padding=output_padding)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    layer = ConvTranspose(6, 4, k, 2, padding, output_padding)
    with torch.no_grad():
        layer.load_state_dict(state_dict_from_jax_variables(variables))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    if (padding, output_padding) == ((k - 1) // 2, k % 2):
        assert want.shape[1:3] == (10, 14)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)


@pytest.mark.parametrize("cin,features,stride", [(64, 16, 1), (32, 16, 2),
                                                 (32, 16, 1)])
def test_bottleneck_matches_jax(cin, features, stride):
    """The Bottleneck (V1.5, output 4x features) in eval mode (kernel B
    sites run their plain version) and in train mode (batch statistics and
    the new running statistics), identity and 1x1 shortcuts."""
    rng = np.random.default_rng(cin + stride)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    jm = JaxBottleneck(features, stride=stride)
    variables = random_jax_variables(jm, (jnp.asarray(x),), seed=stride)
    blk = Bottleneck(cin, features, stride)
    blk.load_state_dict(state_dict_from_jax_variables(
        variables, like=blk.state_dict()))
    assert blk.has_downsample == (cin != 4 * features or stride != 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = blk.eval()(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **EXACT)

    want, mut = jm.apply(variables, jnp.asarray(x), True,
                         mutable=["batch_stats"])
    with torch.no_grad():
        got = blk.train()(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    stats = state_dict_from_jax_variables({"batch_stats": mut["batch_stats"]})
    for k, w in stats.items():
        np.testing.assert_allclose(blk.state_dict()[k].numpy(), w.numpy(),
                                   err_msg=k, **EXACT)


# kernel B sites per eval-mode forward, counted from the module structure:
# an encoder has its stem and 2 (BasicBlock) or 3 (Bottleneck) per block,
# an UpProj block 2, a DeConv or UpConv block 1
SITES = [("resnet18_multistage", "upproj", 84),
         ("resnet34_latefusion", "upproj", 74),
         ("resnet50_multistage", "upproj", 212),
         ("resnet18", "upproj", 25),
         ("resnet18_latefusion", "deconv2", 38)]


@pytest.mark.parametrize("arch,decoder,sites", SITES,
                         ids=[f"{a}-{d}" for a, d, _ in SITES])
def test_kernel_b_sites_per_forward(arch, decoder, sites, monkeypatch):
    """Kernel B's wrapper is reached once per eval-mode BN->ReLU site; on
    the CPU it runs the plain version and launches nothing. Train mode
    never reaches it."""
    calls = []
    wrapped = kernels.scale_bias_relu

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(kernels, "scale_bias_relu", counting)
    wrapped.launches = 0
    model, spec = create_model(arch, device="cpu", decoder=decoder,
                               output_size=(32, 64))
    init_random(model, 0)
    rng = np.random.default_rng(0)
    prepared = {"rgb": torch.rand(1, 32, 64, 3),
                "radar": torch.from_numpy(rng.uniform(
                    0, 50, (1, 32, 64, 1)).astype(np.float32))}
    inputs = pack_model_inputs(prepared, spec.input_kind)
    with torch.inference_mode():
        model(*inputs)
    assert len(calls) == sites
    with torch.no_grad():
        model.train()(*inputs)
    assert len(calls) == sites and wrapped.launches == 0


def test_registry_is_the_jax_registry():
    assert set(ARCH_REGISTRY) == set(JAX_REGISTRY)
    for name, spec in ARCH_REGISTRY.items():
        assert (spec.input_kind, spec.multistage) == (
            JAX_REGISTRY[name].input_kind, JAX_REGISTRY[name].multistage), name
    assert set(DECODER_KINDS) == set(JAX_DECODERS)
    assert MODALITY_CHANNELS == {"rgb": 3, "rgbd": 4, "d": 1}
    with pytest.raises(KeyError, match="unknown arch"):
        create_model("resnet101", device="cpu")


def test_single_branch_predictor_matches_jax():
    """The whole slice for a single-branch arch: raw batch -> z-buffer of a
    one-sweep radar -> concat(rgb, radar) -> resnet18/upproj, both
    Predictors from the same variables."""
    h, w = 64, 96
    cfg = ServeConfig(arch="resnet18", modality="rgbd", height=h, width=w,
                      num_sweeps=1)
    jpred = JaxPredictor(JaxTrainConfig(
        data=JaxDataConfig(height=h, width=w, num_sweeps=1),
        model=JaxModelConfig(arch="resnet18", modality="rgbd")), None, None)
    variables = random_jax_variables(
        jpred.model, (jnp.zeros((1, h, w, 4), jnp.float32),), seed=8)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    batch = SyntheticNuScenes(3, spec=SampleSpec(
        height=h, width=w, num_sweeps=1, lidar_points=2048),
        seed=2).batch(range(3))
    want = jpred.predict(batch)
    got = Predictor(cfg, state_dict_from_jax_variables(variables),
                    device="cpu").predict(batch)
    assert got.shape == (3, h, w)
    np.testing.assert_allclose(got, want, **TOL)
