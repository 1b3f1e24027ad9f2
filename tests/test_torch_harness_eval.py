"""--evaluate across the packages: a JAX run's checkpoint (parameters, BN
statistics, SGD momentum, step) is restored through the JAX package, carried
across with convert.state_dict_from_jax_variables and
convert.optimizer_state_from_jax, saved with the port's CheckpointManager
next to the run's config.json, and evaluated by the port's CLI. Its
validation row matches the JAX Trainer's --evaluate within rtol 1e-4, and
Predictor.from_run's predictions match the JAX Predictor.from_run's within
the PARITY tolerance (atol 2e-4, rtol 1e-3). 64x96, 2 sweeps, B=8,
resnet18_multistage / upproj, packed val shards."""

import dataclasses
import os

import jax
import numpy as np
import optax
import torch

from radar_depth_tpu import config as jconfig
from radar_depth_tpu.inference import Predictor as JaxPredictor
from radar_depth_tpu.models import create_model as jax_create_model
from radar_depth_tpu.train import checkpoint as jckpt
from radar_depth_tpu.train.loop import Trainer as JaxTrainer
from radar_depth_tpu.train.state import create_train_state as jax_train_state
from radar_depth_tpu.train.state import make_optimizer
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.convert import (
    optimizer_state_from_jax,
    state_dict_from_jax_variables,
)
from radar_depth_tpu_torch.data.packed import PackedDataset
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.models import create_model
from radar_depth_tpu_torch.train import checkpoint as ckpt_lib
from radar_depth_tpu_torch.train.main import run
from radar_depth_tpu_torch.train.state import create_train_state
from tests.test_torch_harness import (  # noqa: F401  (fixture)
    METRIC_COLS,
    base_argv,
    few_threads,
    write_split,
)
from tests.test_torch_models import random_jax_variables
from tests.test_torch_train import (  # noqa: F401  (fixture)
    _train_variables,
    native_float32_convs,
)

H, W = 64, 96


def _with_trace(opt_state, trace):
    """optax chain(add_decayed_weights, sgd(momentum)) state with ``trace``
    as the momentum."""
    decay, (tr, rest) = opt_state
    assert isinstance(tr, optax.TraceState)
    return decay, (tr._replace(trace=trace), rest)


def test_evaluate_jax_checkpoint_in_the_port(tmp_path):
    data = write_split(tmp_path / "data")
    jrun, prun = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    os.makedirs(jrun)
    jcfg = jconfig.parse_command(base_argv(data) + ["--output-dir", jrun])
    jconfig.save_config(jcfg, os.path.join(jrun, "config.json"))

    # a JAX run's checkpoint: trained-looking weights, momentum, step 5
    jmodel, _ = jax_create_model("resnet18_multistage", output_size=(H, W))
    rgb = np.zeros((1, H, W, 3), np.float32)
    variables = _train_variables(
        random_jax_variables(jmodel, (rgb, rgb[..., :1]), seed=17))
    rng = np.random.default_rng(4)
    trace = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32) * 1e-2,
        variables["params"])
    jstate = jax_train_state(variables, make_optimizer(jcfg.optim, 2))
    jstate = jstate.replace(step=np.int32(5),
                            opt_state=_with_trace(jstate.opt_state, trace))
    mgr = jckpt.CheckpointManager(jrun)
    mgr.save(0, jax.tree_util.tree_map(np.asarray, jstate), {"rmse": 3.0},
             wait=True)
    mgr.close()

    # JAX's --evaluate
    jtr = JaxTrainer(jconfig.parse_command(
        ["--evaluate", jrun, "--platform", "cpu",
         "--output-dir", str(tmp_path / "jax_eval")]))
    jtr.load_for_evaluate()
    want = jtr.validate(0, viz=False)
    template = jax.tree_util.tree_map(np.asarray, jtr.state)
    jtr.close()

    # restored through the JAX package, carried across, saved by the port
    restored = jckpt.restore_for_evaluate(jrun, template)
    cfg = dataclasses.replace(
        config.load_config(os.path.join(jrun, "config.json")),
        output_dir=prun)
    os.makedirs(prun)
    config.save_config(cfg, os.path.join(prun, "config.json"))
    model, _ = create_model("resnet18_multistage", device="cpu",
                            output_size=(H, W), param_dtype=torch.float32)
    state = create_train_state(model, cfg.optim, 2)
    model.load_state_dict(state_dict_from_jax_variables(
        {"params": restored.params, "batch_stats": restored.batch_stats},
        like=model.state_dict()))
    state.optimizer.load_state_dict(optimizer_state_from_jax(
        restored.opt_state[1][0].trace, like=state))
    state.step = int(restored.step)
    ckpt_lib.CheckpointManager(prun).save(0, state, {"rmse": 3.0}, wait=True)
    payload = ckpt_lib.load_payload(os.path.join(prun, "checkpoints", "0"))
    assert payload["step"] == 5
    names = [n for n, _ in model.named_parameters()]
    want_bufs = state_dict_from_jax_variables({"params": trace})
    for i, n in enumerate(names):
        assert torch.equal(
            payload["optimizer"]["state"][i]["momentum_buffer"],
            want_bufs[n]), n

    # the port's --evaluate of that run
    got = run(["--evaluate", prun, "--platform", "cpu",
               "--output-dir", str(tmp_path / "port_eval")])["validation"]
    assert got["count"] == want["count"] == 8
    for k in METRIC_COLS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)

    batch = PackedDataset(os.path.join(data, "val")).batch(range(8))
    mine = Predictor.from_run(prun, device="cpu").predict(batch)
    theirs = JaxPredictor.from_run(jrun).predict(batch)
    assert np.abs(theirs).max() > 1.0  # depth-sized predictions
    np.testing.assert_allclose(mine, theirs, atol=2e-4, rtol=1e-3)
