"""The port's train and eval steps against the JAX package's, on the flagship
arch (resnet18_multistage / upproj) at 64x96, B=2, with the same variables
carried across by radar_depth_tpu_torch.convert and the augmentation
parameters drawn by JAX (jax.random streams cannot be reproduced in torch)
and handed to the port. The preprocessed batches are bit-identical to the
JAX step's (tests/test_torch_augment.py).

Two precisions, because the float32 gradients of this net are
ill-conditioned at this size: BN in train mode over 12 values per channel
(layer4) and channels that are nearly constant where the radar is empty
make many parameter gradients sums that nearly cancel, so either framework's
float32 gradient of such a tensor carries percent-level rounding error.
Gradients and updates are compared per tensor as ||port - jax|| / (||jax||
+ sqrt(n) * rms), rms the root mean square over all parameters, so that a
near-cancelling tensor (a BN bias whose exact gradient is 0, say) is
measured against the scale of the terms it sums.
- The math: train-mode loss, every gradient and the new BN statistics in
  float64 on both sides, gradients within 1e-6 (JAX rounds its prediction
  and loss to float32).
- The float32 steps as they run: loss and metric sums rtol 1e-4 at each
  step, BN running statistics atol 1e-5, rtol 1e-4, parameter updates
  within 5e-2. Each step starts
  from the JAX step's parameters, the port keeping its own momentum buffers,
  so the second step reads the momentum without the first step's rounding
  growing through the forward.

Parity runs pin full float32 on the CPU: torch's oneDNN convolutions are
off for these tests (their float32 sums lose about two digits against the
native ones), as TF32 is off in a parity run on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig as JaxDataConfig
from radar_depth_tpu.config import ModelConfig as JaxModelConfig
from radar_depth_tpu.config import OptimConfig as JaxOptimConfig
from radar_depth_tpu.config import TrainConfig as JaxTrainConfig
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.objectives import multistage_loss as jax_multistage_loss
from radar_depth_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from radar_depth_tpu.ops.augment import make_affine as jax_make_affine
from radar_depth_tpu.ops.augment import sample_affine_params
from radar_depth_tpu.train import step as jstep
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.models import create_model, init_random
from radar_depth_tpu_torch.models.layers import BatchNorm
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.augment import make_affine
from radar_depth_tpu_torch.ops.preprocess import prepare_train_batch
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.train.step import (
    make_eval_step,
    make_micro_grad_fn,
    make_preprocess_config,
    make_train_step,
)
from tests.test_torch_models import random_jax_variables

H, W, SWEEPS, B = 64, 96, 3, 2
ARCH = "resnet18_multistage"
MODEL_KW = dict(decoder="upproj", abs_threshold=20.0)
SUMS_RTOL = 1e-4
F64_TOL = 1e-6
UPDATE_TOL = 5e-2
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
STEPS_PER_EPOCH = 10


@pytest.fixture(autouse=True)
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _configs(accum=1):
    jcfg = JaxTrainConfig(
        data=JaxDataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=JaxModelConfig(arch=ARCH, **MODEL_KW),
        optim=JaxOptimConfig(grad_accum=accum), batch_size=B)
    cfg = TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=ARCH, **MODEL_KW),
        optim=OptimConfig(grad_accum=accum), batch_size=B)
    return jcfg, cfg


def _with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


def _train_variables(variables):
    """Random variables made ready for training: BN scale 1 and bias 0 (a
    freshly initialised flax BN; random BN biases turn the empty-radar
    regions into large constant channels, the worst case for float32 batch
    statistics), and both stages' 3x3 head kernels positive and scaled up,
    so every prediction is a positive depth around 16 m (about half the
    radar returns pass the 20 m filter) and 1/pred in the inverse metrics is
    well-conditioned. BN running statistics stay
    random, so the momentum update is visible."""
    def fix(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fix(v, path + (k,))
            elif k == "scale":
                out[k] = np.ones_like(v)
            elif k == "bias":
                out[k] = np.zeros_like(v)
            elif path[-1] == "conv3":
                out[k] = np.abs(v) * 50.0
            else:
                out[k] = v
        return out

    return {"params": fix(variables["params"]),
            "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def setup():
    jmodel, jspec = jax_create_model(ARCH, output_size=(H, W), **MODEL_KW)
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = _train_variables(
        random_jax_variables(jmodel, (rgb, rgb[..., :1]), seed=11))
    ds = SyntheticNuScenes(2 * B, spec=SampleSpec(height=H, width=W,
                                                  num_sweeps=SWEEPS,
                                                  lidar_points=2048), seed=5)
    return jmodel, jspec, variables, ds


def _port_model(variables, dtype=torch.float32):
    model, spec = create_model(ARCH, device="cpu", output_size=(H, W),
                               dtype=dtype, param_dtype=dtype, **MODEL_KW)
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    return model, spec


def _torch_tree(tree, col):
    """A JAX params or batch_stats tree -> {port name: float64 array}."""
    return {k: v.double().numpy() for k, v in
            state_dict_from_jax_variables({col: tree}).items()}


def _flat_float64(tree, batch_stats=False):
    """A float64 JAX tree -> {port name: float64 array}, without the float32
    cast of ``convert.state_dict_from_jax_variables``."""
    leaf = ({"mean": "running_mean", "var": "running_var"} if batch_stats
            else {"scale": "weight", "bias": "bias", "kernel": "weight"})
    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name = ".".join(path + (leaf[k],))
                out[name] = v.transpose(3, 2, 0, 1) if k == "kernel" else v

    walk(tree, ())
    return out


def _aug_params(key):
    """JAX's augmentation parameters for ``key``. XLA's float32 sin differs
    from the port's correctly rounded one for a few angles in a thousand
    (tests/test_torch_augment.py counts them); these keys draw none, so the
    affines, and with them the maps, are bit-identical."""
    params = tuple(np.asarray(p) for p in
                   sample_affine_params(key, JaxAugmentConfig(), B))
    want = jax.jit(lambda s, a, f: jax_make_affine(s, a, f, H, W))(*params[:3])
    got = make_affine(*(torch.from_numpy(np.array(p)) for p in params[:3]),
                      H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return params


def _assert_sums(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=SUMS_RTOL, atol=0, err_msg=k)


def _assert_stats(model, want: dict):
    buffers = {k: v.double().numpy() for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    assert set(buffers) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(buffers[k], w, err_msg=k, **STATS_TOL)


def _assert_close(got: dict, want: dict, tol: float, what: str):
    """Per tensor ||got - want|| / (||want|| + sqrt(n) * rms) <= tol, rms the
    root mean square over all tensors of ``want``."""
    assert set(got) == set(want)
    rms = np.sqrt(sum(np.sum(np.square(w)) for w in want.values())
                  / sum(w.size for w in want.values()))
    for k, w in want.items():
        err = np.linalg.norm(got[k] - w) / (np.linalg.norm(w)
                                            + np.sqrt(w.size) * rms)
        assert err <= tol, f"{what} {k}: error {err:.2e}"


def test_train_mode_gradients_match_jax_in_float64(setup, monkeypatch):
    """Train-mode forward, multistage L1 loss, every gradient and the new BN
    statistics, both sides in float64 on the same prepared batch. The JAX
    package's packed decoder tail keeps its BN statistics in float32, so it
    is switched to the plain UpProj block, the same math."""
    _, _, variables, ds = setup
    _, cfg = _configs()
    batch = ds.batch(range(B))
    aug = _aug_params(jax.random.PRNGKey(3))
    model, spec = _port_model(variables, torch.float64)
    grads, sums = make_micro_grad_fn(model, spec, cfg)(batch, aug_params=aug)
    prep = {k: jnp.asarray(v.numpy()) for k, v in prepare_train_batch(
        batch, make_preprocess_config(cfg), aug, device="cpu").items()}

    monkeypatch.setenv("RDT_TAIL_PACKED", "0")
    with jax.enable_x64(True):
        jm, _ = jax_create_model(ARCH, output_size=(H, W), dtype=jnp.float64,
                                 **MODEL_KW)
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     variables)

        def loss_fn(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": v64["batch_stats"]},
                                prep["rgb"], prep["radar"], train=True,
                                mutable=["batch_stats"])
            target = prep["target"].astype(jnp.float64)
            return jax_multistage_loss(out, target), mut["batch_stats"]

        (loss, stats), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        loss, stats, jgrads = jax.tree_util.tree_map(
            np.asarray, (loss, stats, jgrads))
    np.testing.assert_allclose(float(sums["loss"]), float(loss), rtol=1e-6)
    _assert_close({k: g.numpy() for k, g in grads.items()},
                  _flat_float64(jgrads), F64_TOL, "gradient")
    got = {k: v.numpy() for k, v in model.state_dict().items()
           if k.endswith(("running_mean", "running_var"))}
    want_stats = _flat_float64(stats, batch_stats=True)
    assert set(got) == set(want_stats)
    for k, w in want_stats.items():  # the port stores them in float32
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_eval_step_matches_jax(setup):
    """Eval-mode metric sums and loss (kernel C and kernel B sites run their
    plain versions on the CPU), with the blend policy on."""
    jmodel, jspec, variables, ds = setup
    jcfg, cfg = (_with_model(c, blend_tau=0.3) for c in _configs())
    batch = ds.batch(range(B, 2 * B))
    jeval = jax.jit(jstep.make_eval_step(jmodel, jspec, jcfg))
    want = jeval(variables["params"], variables["batch_stats"],
                 {k: jnp.asarray(v) for k, v in batch.items()})
    model, spec = _port_model(variables)
    kernels.zbuffer_min_depth_sorted.launches = 0
    kernels.scale_bias_relu.launches = 0
    _assert_sums(make_eval_step(model, spec, cfg)(batch), want)
    assert kernels.zbuffer_min_depth_sorted.launches == 0
    assert kernels.scale_bias_relu.launches == 0


def test_batchnorm_train_mode_is_flax_semantics():
    """Train-mode BN normalizes with the biased batch variance and moves the
    running statistics by 0.9*old + 0.1*batch with the biased variance
    (torch's F.batch_norm would store the unbiased one, 9% larger at n=12);
    eval mode uses the running statistics."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 2, 3, generator=g) * 2 + 1
    bn = BatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2]))
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    y = bn.train()(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    want = ((x - mean.view(1, -1, 1, 1))
            / torch.sqrt(var.view(1, -1, 1, 1) + 1e-5)
            * bn.weight.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1))
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    r = torch.randn(x.shape, generator=g)
    torch.testing.assert_close(bn(x, relu=True, residual=r),
                               torch.relu(want + r), atol=1e-5, rtol=1e-5)
    scale, bias = bn.eval().folded()
    torch.testing.assert_close(
        bn(x), x * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1))


def test_bf16_train_step_keeps_float32_weights():
    """bfloat16 compute with float32 master weights: the convs cast per
    call, the gradients and the update stay float32, the loss is finite,
    and no kernel launches on the CPU."""
    cfg = _with_model(_configs()[1], dtype="bfloat16")
    model, spec = create_model(ARCH, device="cpu", output_size=(H, W),
                               dtype=torch.bfloat16, param_dtype=torch.float32,
                               **MODEL_KW)
    init_random(model, 3)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    kernels.zbuffer_min_depth_sorted.launches = 0
    state = create_train_state(model, cfg.optim, STEPS_PER_EPOCH)
    batch = SyntheticNuScenes(B, spec=SampleSpec(
        height=H, width=W, num_sweeps=SWEEPS, lidar_points=2048),
        seed=1).batch(range(B))
    with torch.backends.mkldnn.flags(enabled=True):  # fast bfloat16 convs
        sums = make_train_step(model, spec, cfg)(
            state, batch, generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(sums["loss"]))
    for k, v in model.named_parameters():
        assert v.dtype == torch.float32, k
        assert not torch.equal(v, before[k]), k
    assert kernels.zbuffer_min_depth_sorted.launches == 0
