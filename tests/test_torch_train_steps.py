"""The port's float32 train step against the JAX package's jitted one, two
steps each without and with gradient accumulation. Setup, tolerances and
their reasons: tests/test_torch_train.py, whose helpers this file uses; the
two files are separate so that the two JAX compiles of the steps run on
another worker than the float64 and eval checks."""

import jax
import jax.numpy as jnp
import pytest
import torch

from radar_depth_tpu.train import step as jstep
from radar_depth_tpu.train.state import create_train_state as jax_train_state
from radar_depth_tpu.train.state import make_optimizer
from radar_depth_tpu_torch.train.state import create_train_state
from radar_depth_tpu_torch.train.step import make_train_step
from tests.test_torch_train import (  # noqa: F401  (fixtures)
    B,
    STEPS_PER_EPOCH,
    UPDATE_TOL,
    _assert_close,
    _assert_stats,
    _assert_sums,
    _aug_params,
    _configs,
    _port_model,
    _torch_tree,
    native_float32_convs,
    setup,
)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(setup, accum):
    """Two float32 SGD steps of the jitted JAX step and of the port: the
    sums of each step, each step's parameter update (the first is -lr*(g +
    wd*p); the second adds the momentum of the first) and the running
    statistics. accum=2 stacks two micro-batches per step, as the JAX step's
    scan does, with the BN statistics carried through them."""
    jmodel, jspec, variables, ds = setup
    jcfg, cfg = _configs(accum)
    if accum == 1:
        batch = ds.batch(range(B))
    else:
        flat = ds.batch(range(B * accum))
        batch = {k: v.reshape((accum, B) + v.shape[1:])
                 for k, v in flat.items()}
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    jstate = jax_train_state(jax.tree_util.tree_map(jnp.asarray, variables),
                             tx)
    jtrain = jax.jit(jstep.make_train_step(jmodel, jspec, jcfg, tx))
    model, spec = _port_model(variables)
    state = create_train_state(model, cfg.optim, STEPS_PER_EPOCH)
    train = make_train_step(model, spec, cfg)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for s in range(2):
        before = {k: v.detach().double().numpy().copy()
                  for k, v in model.named_parameters()}
        jstate, jsums = jtrain(jstate, jbatch, key)
        k = jax.random.fold_in(key, s)
        params = (_aug_params(k) if accum == 1 else
                  [_aug_params(jax.random.fold_in(k, i)) for i in range(accum)])
        sums = train(state, batch, aug_params=params)
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
