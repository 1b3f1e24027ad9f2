"""The port's host-augmented train step (make_train_step(host_augmented=
True): the batch was augmented by the native loader's threads, the step
runs the eval preprocessing) against the JAX package's, on batches of the
native loader with augmentation (64x96, 2 sweeps, B=8, resnet18_multistage
/ upproj). Tolerances and their reasons as in tests/test_torch_train.py:
float64 gradients within 1e-6; float32 sums rtol 1e-4, updates within 5e-2
normalized, BN statistics atol 1e-5, rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.config import DataConfig as JaxDataConfig
from radar_depth_tpu.config import ModelConfig as JaxModelConfig
from radar_depth_tpu.config import TrainConfig as JaxTrainConfig
from radar_depth_tpu.data import packed as jpacked
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.objectives import multistage_loss as jax_multistage_loss
from radar_depth_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from radar_depth_tpu.ops.preprocess import prepare_eval_batch as jax_prepare
from radar_depth_tpu.train import step as jstep
from radar_depth_tpu.train.state import create_train_state as jax_train_state
from radar_depth_tpu.train.state import make_optimizer
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.data import packed
from radar_depth_tpu_torch.models import create_model
from radar_depth_tpu_torch.ops.augment import AugmentConfig
from radar_depth_tpu_torch.ops.preprocess import prepare_eval_batch
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.train.step import (
    make_micro_grad_fn,
    make_preprocess_config,
    make_train_step,
)
from tests.test_torch_harness import few_threads  # noqa: F401  (fixture)
from tests.test_torch_models import random_jax_variables
from tests.test_torch_train import (  # noqa: F401  (fixture)
    F64_TOL,
    UPDATE_TOL,
    _assert_close,
    _assert_stats,
    _assert_sums,
    _flat_float64,
    _torch_tree,
    _train_variables,
    native_float32_convs,
)

H, W, SWEEPS, B = 64, 96, 2, 8
ARCH = "resnet18_multistage"
MODEL_KW = dict(decoder="upproj", abs_threshold=20.0)
STEPS_PER_EPOCH = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two host-augmented batches (both packages' loaders give the same
    arrays) and random JAX variables made ready for training."""
    root = tmp_path_factory.mktemp("step")
    spec = SampleSpec(height=H, width=W, num_sweeps=SWEEPS, lidar_points=2048)
    ds = SyntheticNuScenes(2 * B, spec=spec, seed=2)
    packed.write_shards(str(root), (ds[i] for i in range(2 * B)))
    mine = packed.NativeBatchLoader(packed.PackedDataset(str(root)), B,
                                    seed=5, threads=2,
                                    augment=AugmentConfig())
    theirs = jpacked.NativeBatchLoader(jpacked.PackedDataset(str(root)), B,
                                       seed=5, threads=2,
                                       augment=JaxAugmentConfig())
    batches = []
    for _ in range(2):
        got, want = next(mine), next(theirs)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        batches.append(got)
    mine.close()
    theirs.close()
    jmodel, jspec = jax_create_model(ARCH, output_size=(H, W), **MODEL_KW)
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = _train_variables(
        random_jax_variables(jmodel, (rgb, rgb[..., :1]), seed=13))
    return jmodel, jspec, variables, batches


def _configs():
    jcfg = JaxTrainConfig(
        data=JaxDataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=JaxModelConfig(arch=ARCH, **MODEL_KW), batch_size=B)
    cfg = TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=ARCH, **MODEL_KW), batch_size=B)
    return jcfg, cfg


def _port_model(variables, dtype=torch.float32):
    model, spec = create_model(ARCH, device="cpu", output_size=(H, W),
                               dtype=dtype, param_dtype=dtype, **MODEL_KW)
    model.load_state_dict(state_dict_from_jax_variables(
        variables, like=model.state_dict()))
    return model, spec


def test_host_augmented_gradients_match_jax_in_float64(setup, monkeypatch):
    """On a loader-augmented batch: the step's preprocessing is the eval
    one (radar map and GT equal to JAX's), and the train-mode loss, every
    gradient and the new BN statistics agree in float64."""
    _, _, variables, batches = setup
    _, cfg = _configs()
    batch = batches[0]
    pre = make_preprocess_config(cfg)
    prep = prepare_eval_batch(batch, pre, device="cpu")
    want = jax_prepare({k: jnp.asarray(v) for k, v in batch.items()},
                       jstep.make_preprocess_config(_configs()[0]))
    for k in ("radar", "target"):
        np.testing.assert_array_equal(prep[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    model, spec = _port_model(variables, torch.float64)
    grads, sums = make_micro_grad_fn(model, spec, cfg,
                                     host_augmented=True)(batch)
    prep = {k: jnp.asarray(v.numpy()) for k, v in prep.items()}

    monkeypatch.setenv("RDT_TAIL_PACKED", "0")
    with jax.enable_x64(True):
        jm, _ = jax_create_model(ARCH, output_size=(H, W), dtype=jnp.float64,
                                 **MODEL_KW)
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                     variables)

        def loss_fn(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": v64["batch_stats"]},
                                prep["rgb"].astype(jnp.float64),
                                prep["radar"].astype(jnp.float64),
                                train=True, mutable=["batch_stats"])
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
    for k, w in _flat_float64(stats, batch_stats=True).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_host_augmented_train_steps_match_jax(setup):
    """Two float32 SGD steps of JAX's jitted make_train_step(host_augmented=
    True) and of the port's, one loader batch each: the sums, each step's
    parameter update and the running statistics."""
    jmodel, jspec, variables, batches = setup
    jcfg, cfg = _configs()
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    jstate = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                             tx)
    jtrain = jax.jit(jstep.make_train_step(jmodel, jspec, jcfg, tx,
                                           host_augmented=True))
    model, spec = _port_model(variables)
    state = create_train_state(model, cfg.optim, STEPS_PER_EPOCH)
    train = make_train_step(model, spec, cfg, host_augmented=True)
    key = jax.random.PRNGKey(0)
    for batch in batches:
        before = {k: v.detach().double().numpy().copy()
                  for k, v in model.named_parameters()}
        jstate, jsums = jtrain(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, key)
        sums = train(state, batch)
        _assert_sums(sums, jsums)
        jp = _torch_tree(jstate.params, "params")
        _assert_close({k: v.detach().double().numpy() - before[k]
                       for k, v in model.named_parameters()},
                      {k: v - before[k] for k, v in jp.items()}, UPDATE_TOL,
                      "update")
        _assert_stats(model, _torch_tree(jstate.batch_stats, "batch_stats"))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(jp[name]))
    assert state.step == int(jstate.step) == 2
