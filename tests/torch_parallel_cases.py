"""The port's data-parallel train and eval steps (parallel/mesh.py through
train/step.py) in two gloo processes on the CPU, against the port's
single-process step over the same global batch and against the JAX step
jitted on a 2-device CPU mesh, as the JAX Trainer shards it: the cases,
the worker of the two ranks, the references and the checks that
tests/test_torch_parallel_steps.py (the train cases held against JAX:
grad_accum 1 and 2, the uncertainty arch), tests/
test_torch_parallel_steps_port.py (the other train cases) and tests/
test_torch_parallel_steps_eval.py (the eval pass and the two-axis meshes)
share, each file starting its own pair of processes on its own cases
(``start``), so that the three run side by side.

The flagship (resnet18_multistage / upproj) at 64x96, 2 sweeps, global
batch 4 (2 rows per rank), weights converted from one set of JAX variables
and the augmentation parameters drawn by JAX for the global batch
(tests/test_torch_train.py explains both). A pair of processes runs a file's
cases and prints one JSON line per case and rank; the files' tests assert
them case by case:
- train steps: grad_accum 1 and 2, the uncertainty arch, --metric-avg
  batch and sample, --sparsifier uar with JAX's uniforms, and, against
  the port alone, --remat, --sparsifier uar and the augmentation drawn
  from a seeded generator for the global batch, and a mesh step whose
  model later also gets a step without the mesh; each in float32 and in
  float64: loss and metric sums, updated parameters and BN running
  statistics; rank 0 also runs the single-process step over the global
  batch from the same weights and draws;
- the eval pass over 5 samples at eval batch 4, the ragged second batch
  padded (pad_batch_to) and split 2/2, in both metric conventions and
  under --sparsifier uar (the port alone: its eval draws come from a
  generator seeded 0 over the padded global batch, and on the CPU the
  first rows of a draw are those of a smaller draw from the same seed);
- metric sums over a (2, 1) and a (1, 2) make_mesh_2d layout.

Tolerances. Against the single-process port step the two runs differ only
in the order of their reductions (BN statistics and the pooled metrics
are summed per rank, then over ranks): loss and sums rtol 1e-5, eval sums
rtol 1e-5, and in float64 parameters and running statistics atol 1e-6. In
float32 that order alone moves this ill-conditioned net's parameters by up
to 2.7e-4 (measured; tests/test_torch_train.py explains the conditioning),
so there the updates are held to that file's float32 bound, 5e-2
normalized (measured 8.2e-3). Against JAX (float32), the bounds of
tests/test_torch_train.py (sums rtol 1e-4, updates 5e-2 normalized,
statistics atol 1e-5 / rtol 1e-4) and, for the eval sums,
tests/test_sharding_consistency.py's rtol 1e-4. Across ranks the
parameters are bit-equal.

Run as a script (``python tests/torch_parallel_cases.py DIR``, with RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT set) this file is the worker of
one rank: it imports the port, never JAX.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

H, W, SWEEPS = 64, 96, 2
B = 4  # global batch
WORLD = 2
EVAL_N, EVAL_B = 5, 4
MODEL_KW = dict(decoder="upproj", abs_threshold=20.0)
FLAGSHIP = "resnet18_multistage"
UNCERTAIN = "resnet18_multistage_uncertainty"
TRAIN_CASES = {
    "accum1-batch": dict(arch=FLAGSHIP, accum=1, metric_avg="batch"),
    "accum2-batch": dict(arch=FLAGSHIP, accum=2, metric_avg="batch"),
    "uncertainty": dict(arch=UNCERTAIN, accum=1, metric_avg="batch"),
    "accum1-sample": dict(arch=FLAGSHIP, accum=1, metric_avg="sample"),
    "sparsifier": dict(arch=FLAGSHIP, accum=1, metric_avg="batch",
                       sparsifier="uar"),
    "remat": dict(arch=FLAGSHIP, accum=1, metric_avg="batch", remat=True),
    # drawn by each process from a generator seeded alike
    "sparsifier-drawn": dict(arch=FLAGSHIP, accum=1, metric_avg="batch",
                             sparsifier="uar", seed=21),
    "augment-drawn": dict(arch=FLAGSHIP, accum=2, metric_avg="batch",
                          seed=22),
    # a step without the mesh built on the model after the mesh step
    "plain-built-after": dict(arch=FLAGSHIP, accum=1, metric_avg="batch",
                              plain_built_after=True),
}
JAX_CASES = [c for c in TRAIN_CASES if c in (
    "accum1-batch", "accum2-batch", "uncertainty", "accum1-sample",
    "sparsifier")]
CONVENTIONS = ("batch", "sample")
EVAL_CASES = {"batch": dict(metric_avg="batch"),
              "sample": dict(metric_avg="sample"),
              "uar": dict(metric_avg="batch", sparsifier="uar")}
LAYOUTS = {"2x1": (2, 1), "1x2": (1, 2)}
DTYPES = ("float32", "float64")
STEPS_PER_EPOCH = 10
PORT_SUMS_RTOL = 1e-5
PORT_STATE_ATOL = 1e-6
JAX_EVAL_RTOL = 1e-4
MESH2D_RTOL = 2e-5
WORKER_TIMEOUT_S = 900


def _cfg(case: dict):
    from radar_depth_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        OptimConfig,
        TrainConfig,
    )

    return TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS,
                        sparsifier=case.get("sparsifier", "none")),
        model=ModelConfig(arch=case["arch"], remat=case.get("remat", False),
                          **MODEL_KW),
        optim=OptimConfig(grad_accum=case.get("accum", 1)), batch_size=B,
        metric_avg=case.get("metric_avg", "batch"))


def _model(case: dict, state_dict):
    from radar_depth_tpu_torch.models import create_model

    kw = dict(MODEL_KW, remat=True) if case.get("remat") else MODEL_KW
    dtype = getattr(torch, case.get("dtype", "float32"))
    model, spec = create_model(case["arch"], device="cpu",
                               output_size=(H, W), dtype=dtype,
                               param_dtype=dtype, **kw)
    model.load_state_dict(state_dict)
    return model, spec


def _stacked(batch: dict, accum: int) -> dict:
    """The first accum * B samples of ``batch``: B of them with accum 1,
    else (accum, B, ...) stacks."""
    if accum == 1:
        return {k: v[:B] for k, v in batch.items()}
    return {k: v[:accum * B].reshape((accum, B) + v.shape[1:])
            for k, v in batch.items()}


def _floats(sums: dict) -> dict:
    return {k: float(v) for k, v in sums.items()}


def _model_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _state_errors(got, want, start: dict) -> dict:
    """How far ``got``'s parameters and running statistics are from
    ``want``'s: the largest absolute difference, and the largest update
    error normalized as tests/test_torch_train.py::_assert_close does."""
    g, w = got.state_dict(), want.state_dict()
    diff = {k: (g[k].double() - w[k].double()).abs().max().item() for k in w}
    upd = {k: w[k].double() - start[k].double() for k, _ in
           want.named_parameters()}
    rms = float(np.sqrt(sum(float((u * u).sum()) for u in upd.values())
                        / sum(u.numel() for u in upd.values())))
    norm = {k: float((g[k].double() - start[k].double() - u).norm())
            / (float(u.norm()) + np.sqrt(u.numel()) * rms)
            for k, u in upd.items()}
    worst = max(diff, key=diff.get)
    return {"state_max_abs": diff[worst], "state_worst": worst,
            "update_err": max(norm.values())}


def _draws(case: dict, given: dict) -> dict:
    """The step's keyword draws: the given ones (JAX's augmentation
    parameters or a sparsifier's uniforms, for the global batch), or a
    generator seeded with the case's seed."""
    if "seed" in case:
        return {"generator": torch.Generator().manual_seed(case["seed"])}
    return given


def _eval_sums(step, batches) -> dict:
    acc = None
    for b in batches:
        s = step(b)
        acc = s if acc is None else {k: acc[k] + s[k] for k in acc}
    return _floats(acc)


# ------------------------------------------------------------- the worker


def _worker(root: str) -> None:
    """One rank: every case of ``root``/cases.json (train cases, the eval
    cases if ``eval``, the layouts), one JSON line each."""
    from radar_depth_tpu_torch.metrics import compute_metric_sums
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )

    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False  # native float32 convolutions
    mesh = pm.make_mesh("cpu")
    with open(os.path.join(root, "cases.json")) as f:
        cases = json.load(f)
    data = dict(np.load(os.path.join(root, "data.npz")))
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    draws = torch.load(os.path.join(root, "draws.pt"), weights_only=True)

    def emit(name, **out):
        print(json.dumps({"case": name, "rank": mesh.rank, **out}),
              flush=True)

    train = {k[6:]: v for k, v in data.items() if k.startswith("train.")}
    for name, case in cases["train"].items():
        for dtype in DTYPES:
            case = dict(case, dtype=dtype)
            cfg = _cfg(case)
            global_batch = _stacked(train, case["accum"])
            model, spec = _model(case, weights[case["arch"]])
            state = create_train_state(model, cfg.optim, STEPS_PER_EPOCH)
            step = make_train_step(model, spec, cfg, mesh=mesh)
            if case.get("plain_built_after"):
                make_train_step(model, spec, cfg)
            pm.COLLECTIVES.clear()
            sums = step(state, pm.local_rows(global_batch, mesh,
                                             accum=case["accum"] > 1),
                        **_draws(case, draws[name]))
            collectives = dict(pm.COLLECTIVES)
            try:
                replicated = pm.assert_replicated(model, mesh)
            except RuntimeError:
                replicated = False
            out = dict(sums=_floats(sums), replicated=replicated,
                       collectives=collectives)
            if mesh.is_main:
                # the single-process step over the global batch, here
                ref, rspec = _model(case, weights[case["arch"]])
                rstate = create_train_state(ref, cfg.optim, STEPS_PER_EPOCH)
                out["ref_sums"] = _floats(make_train_step(ref, rspec, cfg)(
                    rstate, global_batch, **_draws(case, draws[name])))
                out.update(_state_errors(model, ref, weights[case["arch"]]))
                if dtype == "float32" and name in JAX_CASES:
                    torch.save(_model_state(model),
                               os.path.join(root, f"state-{name}.pt"))
            emit(f"{name}@{dtype}", **out)

    val = {k[4:]: v for k, v in data.items() if k.startswith("val.")}
    for name, kw in (EVAL_CASES if cases["eval"] else {}).items():
        case = dict(arch=FLAGSHIP, **kw)
        model, spec = _model(case, weights[FLAGSHIP])
        step = make_eval_step(model, spec, _cfg(case), mesh=mesh)
        batches = []
        for lo in range(0, EVAL_N, EVAL_B):
            b = {k: v[lo:lo + EVAL_B] for k, v in val.items()}
            batches.append(pm.local_rows(pm.pad_batch_to(b, EVAL_B)[0],
                                         mesh))
        emit(f"eval-{name}", sums=_eval_sums(step, batches),
             rows=[int(b["image"].shape[0]) for b in batches])

    pred, target = (torch.from_numpy(data[k]) for k in ("pred", "target"))
    layouts = {"flat": mesh, **{k: pm.make_mesh_2d(*v, platform="cpu")
                                for k, v in cases["layouts"].items()}}
    if not cases["layouts"]:
        layouts = {}
    for layout, m in layouts.items():
        emit(f"mesh-{layout}", axes=list(m.axis_names), shape=list(m.shape),
             sums={conv: _floats(compute_metric_sums(
                 pm.local_rows(pred, m), pm.local_rows(target, m), conv, m))
                 for conv in CONVENTIONS})
    pm.destroy_mesh(mesh)


# ------------------------------------------------------------- the parent


@pytest.fixture(scope="module")
def few_threads():
    """Two torch threads: the suite runs in several processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_draws(key, n):
    """JAX's augmentation parameters for ``key`` over ``n`` samples, with
    the affines checked bit-equal to the port's (tests/test_torch_train.py
    ::_aug_params explains why)."""
    import jax

    from radar_depth_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
    from radar_depth_tpu.ops.augment import make_affine as jax_make_affine
    from radar_depth_tpu.ops.augment import sample_affine_params
    from radar_depth_tpu_torch.ops.augment import make_affine

    params = tuple(np.asarray(p) for p in
                   sample_affine_params(key, JaxAugmentConfig(), n))
    want = jax.jit(lambda s, a, f: jax_make_affine(s, a, f, H, W))(*params[:3])
    got = make_affine(*(torch.from_numpy(np.array(p)) for p in params[:3]),
                      H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return tuple(torch.from_numpy(np.array(p)) for p in params)


def _jax_setup():
    """{arch: (JAX model, spec, variables)} of the two archs."""
    import jax.numpy as jnp

    from radar_depth_tpu.models import create_model as jax_create_model
    from tests.test_torch_models import random_jax_variables
    from tests.test_torch_train import _train_variables
    from tests.test_torch_zoo_train import _variables_for_training

    out = {}
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    for arch, make in ((FLAGSHIP, lambda m: _train_variables(
            random_jax_variables(m, (rgb, rgb[..., :1]), seed=11))),
                       (UNCERTAIN, lambda m: _variables_for_training(
                           m, (rgb, rgb[..., :1]), seed=12))):
        jmodel, jspec = jax_create_model(arch, output_size=(H, W), **MODEL_KW)
        out[arch] = (jmodel, jspec, make(jmodel))
    return out


def _jax_cfg(case: dict):
    from radar_depth_tpu.config import DataConfig, ModelConfig, OptimConfig
    from radar_depth_tpu.config import TrainConfig as JaxTrainConfig

    return JaxTrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS,
                        sparsifier=case.get("sparsifier", "none")),
        model=ModelConfig(arch=case["arch"], **MODEL_KW),
        optim=OptimConfig(grad_accum=case.get("accum", 1)), batch_size=B,
        metric_avg=case.get("metric_avg", "batch"))


def _jax_mesh():
    import jax

    from radar_depth_tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(jax.devices()[:WORLD])


def _jax_train_step(jmodel, jspec, variables, case, batch, key):
    """The JAX train step jitted on a 2-device mesh with the Trainer's
    shardings: state replicated, the batch sharded (dim 1 of the stacks
    under grad accumulation). Returns (state, sums) on the host."""
    import jax
    import jax.numpy as jnp

    from radar_depth_tpu.parallel import (
        batch_sharding,
        replicated_sharding,
        shard_batch,
    )
    from radar_depth_tpu.train import step as jstep
    from radar_depth_tpu.train.state import create_train_state as jax_state
    from radar_depth_tpu.train.state import make_optimizer

    jcfg = _jax_cfg(case)
    mesh = _jax_mesh()
    repl = replicated_sharding(mesh)
    accum = case["accum"] > 1
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    step = jax.jit(jstep.make_train_step(jmodel, jspec, jcfg, tx, mesh=mesh),
                   in_shardings=(repl, batch_sharding(mesh, accum=accum),
                                 repl),
                   out_shardings=(repl, repl))
    jstate = jax.device_put(
        jax_state(jax.tree_util.tree_map(jnp.asarray, variables), tx), repl)
    jstate, sums = step(jstate, shard_batch(batch, mesh, accum=accum), key)
    return jax.tree_util.tree_map(np.asarray, (
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, sums))


def _jax_eval_sums(jmodel, jspec, variables, conv, val):
    """The JAX Trainer's eval pass on a 2-device mesh: each batch padded to
    the eval batch size, sharded, summed."""
    import jax

    from radar_depth_tpu.parallel import (
        batch_sharding,
        pad_batch_to,
        replicated_sharding,
        shard_batch,
    )
    from radar_depth_tpu.train import step as jstep

    mesh = _jax_mesh()
    repl = replicated_sharding(mesh)
    fn = jax.jit(jstep.make_eval_step(jmodel, jspec,
                                      _jax_cfg(dict(arch=FLAGSHIP,
                                                    metric_avg=conv)),
                                      mesh=mesh),
                 in_shardings=(repl, repl, batch_sharding(mesh)),
                 out_shardings=repl)
    acc = None
    for lo in range(0, EVAL_N, EVAL_B):
        b, _ = pad_batch_to({k: v[lo:lo + EVAL_B] for k, v in val.items()},
                            EVAL_B)
        s = jax.tree_util.tree_map(np.asarray, fn(
            variables["params"], variables["batch_stats"],
            shard_batch(b, mesh)))
        acc = s if acc is None else {k: acc[k] + s[k] for k in acc}
    return {k: float(v) for k, v in acc.items()}


def start(tmp_path_factory, train_names, evals: bool = False,
          layouts: bool = False):
    """A ``runs`` fixture's body: start the two ranks on the train cases
    ``train_names`` (and the eval cases, the layouts), compute their
    references while they run, and yield {case: {rank: line}} with the
    references. The models' states go through files in a directory
    removed afterwards."""
    import shutil

    import jax

    from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.metrics import compute_metric_sums
    from radar_depth_tpu_torch.models import create_model
    from radar_depth_tpu_torch.train.step import make_eval_step

    root = str(tmp_path_factory.mktemp("dp"))
    jax_models = _jax_setup()
    weights = {}
    for arch, (_, _, variables) in jax_models.items():
        like = create_model(arch, device="cpu", output_size=(H, W),
                            **MODEL_KW)[0].state_dict()
        weights[arch] = state_dict_from_jax_variables(variables, like=like)
    spec = SampleSpec(height=H, width=W, num_sweeps=SWEEPS, lidar_points=2048)
    train = SyntheticNuScenes(2 * B, spec=spec, seed=5).batch(range(2 * B))
    val = SyntheticNuScenes(EVAL_N, spec=spec, seed=6).batch(range(EVAL_N))
    rng = np.random.default_rng(6)
    pred = rng.uniform(1, 60, size=(8, 16, 24, 1)).astype(np.float32)
    target = rng.uniform(1, 60, size=(8, 16, 24, 1)).astype(np.float32)
    target[rng.uniform(size=target.shape) < 0.6] = 0.0
    np.savez(os.path.join(root, "data.npz"), pred=pred, target=target,
             **{f"train.{k}": v for k, v in train.items()},
             **{f"val.{k}": v for k, v in val.items()})

    key = jax.random.PRNGKey(7)
    step_key = jax.random.fold_in(key, 0)  # the JAX step's first key
    draws = {}
    train_cases = {k: TRAIN_CASES[k] for k in train_names}
    for name, case in train_cases.items():
        if "seed" in case:
            draws[name] = {}
        elif case.get("sparsifier"):  # the JAX step's uniforms
            draws[name] = {"sparse_u": torch.from_numpy(np.array(
                jax.random.uniform(step_key, (B, H, W))))}
        else:
            draws[name] = {"aug_params": (
                _jax_draws(step_key, B) if case["accum"] == 1 else
                [_jax_draws(jax.random.fold_in(step_key, i), B)
                 for i in range(case["accum"])])}
    torch.save(weights, os.path.join(root, "weights.pt"))
    torch.save(draws, os.path.join(root, "draws.pt"))
    with open(os.path.join(root, "cases.json"), "w") as f:
        json.dump({"train": train_cases, "eval": evals,
                   "layouts": LAYOUTS if layouts else {}}, f)

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=repo,
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), root], env=env,
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        # the references, while the ranks run
        ref = {}
        for name in (n for n in JAX_CASES if n in train_cases):
            case = TRAIN_CASES[name]
            jmodel, jspec, variables = jax_models[case["arch"]]
            ref[name] = _jax_train_step(jmodel, jspec, variables, case,
                                        _stacked(train, case["accum"]), key)
        for name, kw in (EVAL_CASES if evals else {}).items():
            case = dict(arch=FLAGSHIP, **kw)
            model, pspec = _model(case, weights[FLAGSHIP])
            step = make_eval_step(model, pspec, _cfg(case))
            ref[f"eval-{name}"] = {"sums": _eval_sums(step, [
                {k: v[lo:lo + EVAL_B] for k, v in val.items()}
                for lo in range(0, EVAL_N, EVAL_B)])}
            if name in CONVENTIONS:
                jmodel, jspec, variables = jax_models[FLAGSHIP]
                ref[f"eval-{name}"]["jax"] = _jax_eval_sums(
                    jmodel, jspec, variables, name, val)
        ref["metrics"] = {conv: _floats(compute_metric_sums(
            torch.from_numpy(pred), torch.from_numpy(target), conv))
            for conv in CONVENTIONS}
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = {}
    for rank, ((out, err), p) in enumerate(zip(outs, procs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}\n{err[-4000:]}"
        for line in out.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                lines.setdefault(rec["case"], {})[rec["rank"]] = rec
    yield {"root": root, "lines": lines, "ref": ref, "weights": weights}
    shutil.rmtree(root, ignore_errors=True)


def _load(runs, stem: str, name: str) -> dict:
    return torch.load(os.path.join(runs["root"], f"{stem}-{name}.pt"),
                      weights_only=True)


def _assert_rel(got: dict, want: dict, rtol: float, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=0,
                                   err_msg=f"{what} {k}")




# ------------------------------------------------------------- the checks


def _load(runs, stem: str, name: str) -> dict:
    return torch.load(os.path.join(runs["root"], f"{stem}-{name}.pt"),
                      weights_only=True)


def _assert_rel(got: dict, want: dict, rtol: float, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=0,
                                   err_msg=f"{what} {k}")


def check_train_step_matches_one_process(runs, name):
    """Both ranks return the single-process step's loss and metric sums in
    float32 and float64; rank 0's updated parameters and running
    statistics are the single-process step's within 1e-6 in float64, and
    its float32 updates within the float32 bound (module docstring)."""
    from tests.test_torch_train import UPDATE_TOL

    for dtype in DTYPES:
        lines = runs["lines"][f"{name}@{dtype}"]
        ref = lines[0]["ref_sums"]
        for rank in range(WORLD):
            _assert_rel(lines[rank]["sums"], ref, PORT_SUMS_RTOL,
                        f"{dtype} rank {rank}")
        assert lines[0]["update_err"] <= UPDATE_TOL, lines[0]
    f64 = runs["lines"][f"{name}@float64"][0]
    assert f64["state_max_abs"] <= PORT_STATE_ATOL, f64


def check_train_step_matches_jax_mesh(runs, name):
    """Rank 0's step against the JAX step on a 2-device mesh: sums, every
    parameter update and the running statistics, with
    tests/test_torch_train.py's bounds and helpers."""
    from tests.test_torch_train import (
        UPDATE_TOL,
        _assert_close,
        _assert_stats,
        _assert_sums,
        _torch_tree,
    )

    jstate, jsums = runs["ref"][name]
    _assert_sums(runs["lines"][f"{name}@float32"][0]["sums"], jsums)
    arch = TRAIN_CASES[name]["arch"]
    before = {k: v.double().numpy()
              for k, v in runs["weights"][arch].items()}
    got = _load(runs, "state", name)
    jp = _torch_tree(jstate["params"], "params")
    _assert_close({k: got[k].double().numpy() - before[k] for k in jp},
                  {k: v - before[k] for k, v in jp.items()}, UPDATE_TOL,
                  "update")
    model, _ = _model(TRAIN_CASES[name], got)
    _assert_stats(model, _torch_tree(jstate["batch_stats"], "batch_stats"))


def check_ranks_stay_bit_equal(runs, name):
    """After the step every rank holds rank 0's parameters and statistics
    bit for bit, and both returned the same sums; the step used all-reduce
    alone (gradients once, BN twice per layer forward, once backward)."""
    for dtype in DTYPES:
        lines = runs["lines"][f"{name}@{dtype}"]
        assert all(lines[r]["replicated"] for r in range(WORLD))
        assert lines[0]["sums"] == lines[1]["sums"]
        assert set(lines[0]["collectives"]) == {"all_reduce"}
        assert lines[0]["collectives"] == lines[1]["collectives"]


def check_ragged_eval_matches_one_process(runs, conv):
    """5 samples at eval batch 4: the second batch is padded with three
    empty samples and split 2/2 (rank 0: sample 4 and a pad; rank 1: two
    pads); the global sums equal the single-process pass over [0:4], [4:5]
    on both ranks, in both metric conventions and under the sparsifier."""
    name = f"eval-{conv}"
    for rank in range(WORLD):
        line = runs["lines"][name][rank]
        assert line["rows"] == [2, 2]
        _assert_rel(line["sums"], runs["ref"][name]["sums"], PORT_SUMS_RTOL,
                    f"rank {rank}")


def check_ragged_eval_matches_jax_mesh(runs, conv):
    name = f"eval-{conv}"
    _assert_rel(runs["lines"][name][0]["sums"], runs["ref"][name]["jax"],
                JAX_EVAL_RTOL, "vs JAX mesh eval")


def check_two_axis_mesh_matches_flat(runs, layout):
    """A (replica, data) layout splits the batch over both axes and reduces
    over the world: the flat mesh's metric sums, bit for bit, and the
    single-process sums (test_sharding_consistency.py's bound)."""
    lines = runs["lines"]
    for rank in range(WORLD):
        got = lines[f"mesh-{layout}"][rank]
        assert got["axes"] == ["replica", "data"]
        assert got["shape"] == list(LAYOUTS[layout])
        assert got["sums"] == lines["mesh-flat"][rank]["sums"]
        for conv in CONVENTIONS:
            _assert_rel(got["sums"][conv], runs["ref"]["metrics"][conv],
                        MESH2D_RTOL, f"{layout} {conv}")


if __name__ == "__main__":
    _worker(sys.argv[1])
