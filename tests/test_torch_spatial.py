"""Spatial partitioning of the port (--spatial; parallel/spatial.py) in one
launch of four gloo processes on the CPU, against the unsharded port and the
JAX package's unsharded graph.

The four ranks make two meshes: (data 2, space 2) and (data 1, space 4).
One launch runs every case and prints one JSON line per case and rank; the
tests below assert them case by case:
- each op along H (the 7x7/s2 stem, 3x3 and 1x1/s2 convs, the 3x3 head,
  the max pool, UnpoolConv, both transposed convs of the DeConv decoders,
  the bilinear resize) in float64, forward and backward, against the same
  op on the whole tensor, at heights that split unevenly and on slabs
  thinner than the halo (at space 4 a window reaches past its neighbours):
  output slab, input gradient and weight gradient within 1e-12;
- train-mode BN over slabs of unequal height, its output, gradients and
  running statistics within 1e-12;
- the "sample" and "batch" metric conventions, a sample's valid pixels in
  several slabs, another's in one and a third sample empty: the sums of one
  process within rtol 1e-12;
- resnet18_multistage with deconv2 and upproj at 64x96, eval mode, float32,
  weights converted from JAX variables: both heads against the JAX
  package's unsharded forward within rtol = atol = 1e-5 (tests/
  test_spatial.py's bound);
- the train micro-step of resnet18_latefusion/deconv2 at 128x96 and at
  64x96 (where GSPMD over-counted the gradients of the JAX package's
  sharded step): in float32, the gradients summed over ranks against JAX's
  make_micro_grad_fn on one device, every tensor's norm ratio within
  0.98-1.02 and the normalized error within tests/test_torch_train.py's
  5e-2; in float64 (BN's parameters and statistics too), against the
  port's single-process step, normalized error and norm ratios within
  1e-9, and the loss within rtol 1e-12;
- Predictor over the (2, 2) mesh against the plain Predictor, at B=4 and at
  B=1 (padded to the data axis), with blend_tau between the samples'
  brightness, predictions within rtol = atol = 1e-5 and the same on every
  rank, evaluate's metrics within rtol 1e-5;
- one float64 flagship train step (B=2, 64x64) over the (2, 2) mesh with
  --remat, --grad-accum 2, the uncertainty arch, --stage2-coarse and
  --sparsifier uar against one process, every parameter in float64: sums
  within rtol 1e-6 (the loss is reported in float32), updates within 1e-9
  normalized (1e-7 under the uncertainty loss, which weights in float32).

Run as a script (``python tests/test_torch_spatial.py DIR``, with RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT set) this file is the worker of
one rank: it imports the port, never JAX.
"""

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

WORLD = 4
SPACES = (2, 4)
MULTI = "resnet18_multistage"
LATE = "resnet18_latefusion"
FWD_H, FWD_W, FWD_B = 64, 96, 4
DECODERS = ("deconv2", "upproj")
GRAD_HEIGHTS = (128, 64)
GRAD_W, GRAD_B, SWEEPS = 96, 4, 2
PRED_B = 4
OP_TOL = 1e-12
METRIC_RTOL = 1e-12
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
F32_GRAD_TOL = 5e-2  # tests/test_torch_train.py's UPDATE_TOL
F64_GRAD_TOL = 1e-9  # every parameter and statistic in float64
RATIO = (0.98, 1.02)
WORKER_TIMEOUT_S = 900
# op cases: kind, channels in/out, kernel, stride, padding, output
# padding, input height (and the resize's output height)
OP_CASES = {
    "stem7x7s2-h13": dict(kind="conv", k=7, s=2, p=3, h=13),
    "stem7x7s2-thin-h9": dict(kind="conv", k=7, s=2, p=3, h=9),
    "conv3x3-h7": dict(kind="conv", k=3, s=1, p=1, h=7),
    "conv3x3s2-h9": dict(kind="conv", k=3, s=2, p=1, h=9),
    "conv1x1s2-h9": dict(kind="conv", k=1, s=2, p=0, h=9),
    "head3x3-h5": dict(kind="head", h=5),
    "maxpool-h11": dict(kind="pool", h=11),
    "maxpool-thin-h7": dict(kind="pool", h=7),
    "unpool5-h5": dict(kind="unpool", k=5, h=5),
    "unpool5-thin-h4": dict(kind="unpool", k=5, h=4),
    "deconv2-h4": dict(kind="convt", k=2, s=2, p=0, op=0, h=4),
    "deconv3-h5": dict(kind="convt", k=3, s=2, p=1, op=1, h=5),
    "resize-h5-to-13": dict(kind="resize", h=5, out=13),
    "resize-thin-h4-to-9": dict(kind="resize", h=4, out=9),
}
BN_HEIGHTS = (7, 9)
CONVENTIONS = ("batch", "sample")
# the train options the JAX package runs under --spatial: one float64 train
# step of the flagship at 64x96 over the (2, 2) mesh against one process
OPTIONS = {
    "remat": dict(remat=True),
    "grad-accum-2": dict(grad_accum=2),
    # its loss weights the stages in float32 (objectives.py casts the
    # log-variances, as the JAX package does): float32's epsilon
    "uncertainty": dict(arch="resnet18_multistage_uncertainty", tol=1e-7),
    "stage2-coarse": dict(stage2_coarse=True),
    "sparsifier-uar": dict(sparsifier="uar"),
}
OPTION_TOL = 1e-9  # normalized update error, everything in float64
OPTION_B, OPTION_W = 2, 64  # one sample per data rank, W/32 = 2


# ------------------------------------------------------------- the worker


def _op(case: dict):
    """(module or None, forward(x, mesh)) of an op case, float64, weights
    drawn from a generator seeded alike on every rank."""
    from radar_depth_tpu_torch.models import layers as L

    kw = dict(dtype=torch.float64, device="cpu")
    kind = case["kind"]
    if kind == "conv":
        m = L.Conv2d(3, 4, case["k"], case["s"], case["p"], **kw)
    elif kind == "head":
        m = L.HeadConv3(3, **kw)
    elif kind == "unpool":
        m = L.UnpoolConv(3, 4, case["k"], **kw)
    elif kind == "convt":
        m = L.ConvTranspose(3, 4, case["k"], case["s"], case["p"], case["op"],
                            **kw)
    else:
        m = None
    if m is not None:
        with torch.no_grad():
            m.weight.copy_(torch.randn(m.weight.shape, dtype=torch.float64,
                                       generator=torch.Generator()
                                       .manual_seed(1)))

        def fwd(x, mesh):
            m.mesh = mesh
            if mesh is not None:
                m.plan_rows(case["h"])
            return m(x)
        return m, fwd
    if kind == "pool":
        return None, lambda x, mesh: L.max_pool_torch(x, 3, 2, 1, mesh,
                                                      case["h"])
    return None, lambda x, mesh: L.resize_bilinear(x, case["out"], 5, mesh,
                                                   case["h"])


def _slab_rows(x, mesh, dim=2):
    """This rank's data rows and space slab of a global tensor."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp

    return sp.slab(pm.local_rows(x, mesh), mesh, dim)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _world_sum(t, mesh):
    from radar_depth_tpu_torch.parallel import mesh as pm

    return pm.all_reduce_sum([t], mesh)[0]


def _op_case(name, case, mesh):
    """Errors of the op on slabs against the op on the whole tensor."""
    module, fwd = _op(case)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 3, case["h"], 5), dtype=torch.float64, generator=gen)
    x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = fwd(x, None)
    g = torch.randn(y.shape, dtype=torch.float64, generator=gen)
    params = [] if module is None else [module.weight]
    want = torch.autograd.grad((y * g).sum(), [x] + params)
    xs = _slab_rows(x.detach(), mesh).clone().requires_grad_(True)
    ys = fwd(xs, mesh)
    got = torch.autograd.grad((ys * _slab_rows(g, mesh)).sum(), [xs] + params)
    out = {"fwd": _max_err(ys, _slab_rows(y.detach(), mesh)),
           "dx": _max_err(got[0], _slab_rows(want[0], mesh)),
           "rows": [int(xs.shape[2]), int(ys.shape[2])]}
    if params:
        out["dw"] = _max_err(_world_sum(got[1], mesh), want[1])
    return out


def _bn_case(h, mesh):
    from radar_depth_tpu_torch.models.layers import BatchNorm

    def make():  # float64 parameters and statistics too
        bn = BatchNorm(3, device="cpu").double().train()
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([1.5, 0.5, 1.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        return bn

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 3, h, 5), dtype=torch.float64, generator=gen) * 2 + 1
    g = torch.randn(x.shape, dtype=torch.float64, generator=gen)
    ref = make()
    x.requires_grad_(True)
    y = ref(x, relu=True)
    want = torch.autograd.grad((y * g).sum(), [x, ref.weight, ref.bias])
    bn = make()
    bn.mesh = mesh
    bn.plan_rows(h)
    xs = _slab_rows(x.detach(), mesh).clone().requires_grad_(True)
    ys = bn(xs, relu=True)
    got = torch.autograd.grad((ys * _slab_rows(g, mesh)).sum(),
                              [xs, bn.weight, bn.bias])
    return {"fwd": _max_err(ys, _slab_rows(y.detach(), mesh)),
            "dx": _max_err(got[0], _slab_rows(want[0], mesh)),
            "dw": max(_max_err(_world_sum(a, mesh), b)
                      for a, b in zip(got[1:], want[1:])),
            "stats": max(_max_err(bn.running_mean, ref.running_mean),
                         _max_err(bn.running_var, ref.running_var)),
            "rows": int(xs.shape[2])}


def _metric_data():
    """pred, target (4, 7, 5, 1) float64: sample 0 valid in every slab,
    sample 1 in its first two rows only, sample 2 empty, sample 3
    random."""
    rng = np.random.default_rng(4)
    pred = rng.uniform(1, 60, (4, 7, 5, 1))
    target = rng.uniform(1, 60, (4, 7, 5, 1))
    target[rng.uniform(size=target.shape) < 0.5] = 0.0
    target[0, ::2, 1] = 7.0
    target[1, 2:] = 0.0
    target[2] = 0.0
    return torch.from_numpy(pred), torch.from_numpy(target)


def _flat(sums):
    return {k: float(v) for k, v in sums.items()}


def _model(arch, decoder, h, w, sd, dtype=torch.float32):
    from radar_depth_tpu_torch.models import create_model

    model, spec = create_model(arch, device="cpu", decoder=decoder,
                               output_size=(h, w), dtype=dtype,
                               param_dtype=dtype)
    model.load_state_dict(sd)
    if dtype == torch.float64:  # BN's float32 parameters and statistics too
        model.double()
    return model, spec


def _forward_case(decoder, mesh, root, weights):
    """Both heads of the spatial eval forward, whole again on every rank;
    rank 0 writes them for the parent."""
    from radar_depth_tpu_torch.models.layers import use_mesh
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp

    data = np.load(os.path.join(root, "fwd.npz"))
    model, _ = _model(MULTI, decoder, FWD_H, FWD_W, weights[decoder])
    use_mesh(model, mesh)
    rgb, radar = (_slab_rows(torch.from_numpy(data[k]), mesh, 1)
                  for k in ("rgb", "radar"))
    pm.COLLECTIVES.clear()
    with torch.no_grad():
        heads = [pm.gather_batch(sp.unslab(o, mesh, FWD_H, 1), mesh)
                 for o in model(rgb, radar)]
    if mesh.is_main:
        np.savez(os.path.join(root, f"fwd-{decoder}.npz"),
                 **{f"head{i}": o.numpy() for i, o in enumerate(heads)})
    return {"collectives": dict(pm.COLLECTIVES),
            "rows": int(rgb.shape[1]), "samples": int(rgb.shape[0])}


def _cfg(h):
    from radar_depth_tpu_torch.config import (
        AugmentConfig,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )

    return TrainConfig(
        data=DataConfig(height=h, width=GRAD_W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=LATE, decoder="deconv2"),
        augment=AugmentConfig(enabled=False), batch_size=GRAD_B)


def _norm_errs(got: dict, want: dict) -> dict:
    """tests/test_torch_train.py::_assert_close's measure per tensor."""
    rms = np.sqrt(sum(float((w * w).sum()) for w in want.values())
                  / sum(w.numel() for w in want.values()))
    return {k: float((got[k] - w).norm())
            / (float(w.norm()) + np.sqrt(w.numel()) * rms)
            for k, w in want.items()}


def _grad_case(h, mesh, root, weights):
    """Micro-step gradients over the mesh, summed over ranks as the train
    step sums them; float32 ones go to the parent, float64 ones are held to
    the single-process step here."""
    from radar_depth_tpu_torch.data import SyntheticNuScenes
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import make_micro_grad_fn

    cfg = _cfg(h)
    batch = SyntheticNuScenes(GRAD_B, spec=cfg.data.sample_spec(),
                              seed=3).batch(range(GRAD_B))
    out = {}
    for dtype in (torch.float32, torch.float64):
        model, spec = _model(LATE, "deconv2", h, GRAD_W, weights["late"],
                             dtype)
        pm.COLLECTIVES.clear()
        grads, sums = make_micro_grad_fn(model, spec, cfg, mesh=mesh)(
            pm.local_rows(batch, mesh))
        names = list(grads)
        grads = dict(zip(names, pm.all_reduce_sum(
            [grads[k] for k in names], mesh)))
        if dtype == torch.float32:
            out["collectives"] = dict(pm.COLLECTIVES)
            out["loss"] = float(sums["loss"])
            if mesh.is_main:
                torch.save(grads, os.path.join(root, f"grads-{h}.pt"))
            continue
        if mesh.is_main:
            ref, rspec = _model(LATE, "deconv2", h, GRAD_W, weights["late"],
                                dtype)
            rgrads, rsums = make_micro_grad_fn(ref, rspec, cfg)(batch)
            errs = _norm_errs(grads, rgrads)
            out["f64_worst"] = max(errs, key=errs.get)
            out["f64_err"] = errs[out["f64_worst"]]
            out["f64_ratio"] = [min(r), max(r)] if (r := [
                float(grads[k].norm() / rgrads[k].norm())
                for k in rgrads if float(rgrads[k].norm()) > 0]) else []
            out["f64_loss"] = [float(sums["loss"]), float(rsums["loss"])]
    return out


def _option_case(option, mesh):
    """One float64 train step with ``option`` over the mesh (every rank) and
    in one process (rank 0), from the same seeded weights and draws."""
    from radar_depth_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        OptimConfig,
        TrainConfig,
    )
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import make_train_step

    o = OPTIONS[option]
    arch = o.get("arch", MULTI)
    accum = o.get("grad_accum", 1)
    cfg = TrainConfig(
        data=DataConfig(height=FWD_H, width=OPTION_W, num_sweeps=SWEEPS,
                        sparsifier=o.get("sparsifier", "none")),
        model=ModelConfig(arch=arch, remat=o.get("remat", False),
                          stage2_coarse=o.get("stage2_coarse", False)),
        optim=OptimConfig(grad_accum=accum), batch_size=OPTION_B)
    spec = SampleSpec(height=FWD_H, width=OPTION_W, num_sweeps=SWEEPS,
                      lidar_points=2048)
    n = OPTION_B * accum
    batch = SyntheticNuScenes(n, spec=spec, seed=6).batch(range(n))
    if accum > 1:
        batch = {k: v.reshape((accum, OPTION_B) + v.shape[1:])
                 for k, v in batch.items()}

    def step(m):
        model, aspec = create_model(
            arch, device="cpu", output_size=(FWD_H, OPTION_W),
            dtype=torch.float64, param_dtype=torch.float64,
            remat=o.get("remat", False),
            stage2_coarse=o.get("stage2_coarse", False))
        init_random(model.double(), 0)
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        state = create_train_state(model, cfg.optim, 10)
        sums = make_train_step(model, aspec, cfg, mesh=m)(
            state, pm.local_rows(batch, m, accum=accum > 1),
            generator=torch.Generator().manual_seed(8))
        return ({k: v.detach() - start[k]
                 for k, v in model.named_parameters()}, _flat(sums))

    pm.COLLECTIVES.clear()
    upd, sums = step(mesh)
    out = {"sums": sums, "collectives": dict(pm.COLLECTIVES)}
    if mesh.is_main:
        ref_upd, out["ref_sums"] = step(None)
        errs = _norm_errs(upd, ref_upd)
        out["worst"] = max(errs, key=errs.get)
        out["update_err"] = errs[out["worst"]]
    return out


def _predictor_case(n, mesh, weights):
    """The spatial Predictor against the plain one in this process."""
    from radar_depth_tpu_torch.config import ServeConfig
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.inference import Predictor

    spec = SampleSpec(height=FWD_H, width=FWD_W, num_sweeps=SWEEPS,
                      lidar_points=2048)
    batch = SyntheticNuScenes(PRED_B, spec=spec, seed=9).batch(range(n))
    bright = batch["image"].reshape(n, -1).mean(1) / 255.0
    tau = float(np.median(bright)) if n > 1 else float(bright[0]) + 0.01
    cfg = ServeConfig(arch=MULTI, decoder="upproj", dtype="float32",
                      height=FWD_H, width=FWD_W, num_sweeps=SWEEPS,
                      abs_threshold=20.0, blend_tau=tau)
    plain = Predictor(cfg, weights["upproj"], device="cpu")
    sp = Predictor(cfg, weights["upproj"], mesh=mesh)
    got, want = sp.predict(batch), plain.predict(batch)
    return {"shape": list(got.shape), "pred_err": float(np.abs(
        got - want).max()), "pred_scale": float(np.abs(want).max()),
        "pred_sum": float(got.astype(np.float64).sum()),
        "dark": int((bright < tau).sum()),
        "metrics": _flat(sp.evaluate(batch)),
        "ref_metrics": _flat(plain.evaluate(batch))}


def _wait_for(path: str) -> str:
    """``path`` once the parent has renamed it into place."""
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.2)
    return path


def _worker(root: str) -> None:
    from radar_depth_tpu_torch.metrics import compute_metric_sums
    from radar_depth_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # native float32 convolutions
    meshes = {s: pm.make_spatial_mesh(s, "cpu") for s in SPACES}
    mesh = meshes[2]
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)

    t0 = time.perf_counter()

    def emit(name, **out):
        print(json.dumps({"case": name, "rank": mesh.rank,
                          "s": time.perf_counter() - t0, **out}), flush=True)

    for s, m in meshes.items():
        emit(f"mesh-{s}", axes=list(m.axis_names), shape=list(m.shape),
             data=[m.data_size, m.data_index],
             space=[m.space_size, m.space_index])
    for s, m in meshes.items():
        for name, case in OP_CASES.items():
            emit(f"op-{name}@{s}", **_op_case(name, case, m))
        for h in BN_HEIGHTS:
            emit(f"bn-{h}@{s}", **_bn_case(h, m))
        pred, target = _metric_data()
        for conv in CONVENTIONS:
            emit(f"metrics-{conv}@{s}", sums=_flat(compute_metric_sums(
                _slab_rows(pred, m, 1), _slab_rows(target, m, 1), conv, m)),
                ref=_flat(compute_metric_sums(pred, target, conv)))
    for decoder in DECODERS:
        emit(f"forward-{decoder}", **_forward_case(decoder, mesh, root,
                                                   weights))
    for n in (PRED_B, 1):
        emit(f"predictor-b{n}", **_predictor_case(n, mesh, weights))
    for option in OPTIONS:
        emit(f"option-{option}", **_option_case(option, mesh))
    weights["late"] = torch.load(_wait_for(os.path.join(root, "late.pt")),
                                 weights_only=True)
    for h in GRAD_HEIGHTS:
        emit(f"grads-{h}", **_grad_case(h, mesh, root, weights))
    mesh.barrier()
    pm.destroy_mesh(mesh)


# ------------------------------------------------------------- the parent


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_late_setup():
    """The JAX latefusion model's variables (flax's initialisers, as the
    JAX Trainer makes them) and its jitted micro-step per height."""
    import dataclasses

    import jax

    from radar_depth_tpu.config import AugmentConfig as JAug
    from radar_depth_tpu.config import DataConfig as JData
    from radar_depth_tpu.config import ModelConfig as JModel
    from radar_depth_tpu.config import TrainConfig as JTrain
    from radar_depth_tpu.models import create_model as jax_create_model
    from radar_depth_tpu.train.step import init_model, make_micro_grad_fn

    base = JTrain(data=JData(height=GRAD_HEIGHTS[0], width=GRAD_W,
                             num_sweeps=SWEEPS),
                  model=JModel(arch=LATE, decoder="deconv2"),
                  augment=JAug(enabled=False), batch_size=GRAD_B)
    fns, variables = {}, None
    for h in GRAD_HEIGHTS:
        cfg = dataclasses.replace(base, data=dataclasses.replace(
            base.data, height=h))
        model, spec = jax_create_model(LATE, decoder="deconv2",
                                       output_size=(h, GRAD_W))
        if variables is None:
            variables = init_model(model, spec, cfg, jax.random.PRNGKey(0))
        fns[h] = (jax.jit(make_micro_grad_fn(model, spec, cfg)), cfg)
    return variables, fns


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks on every case, compute the JAX references while
    they run, and collect {case: {rank: line}}."""
    import jax
    import jax.numpy as jnp

    from radar_depth_tpu.models import create_model as jax_create_model
    from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
    from radar_depth_tpu_torch.data import SyntheticNuScenes
    from radar_depth_tpu_torch.models import create_model
    from tests.test_torch_models import random_jax_variables

    root = str(tmp_path_factory.mktemp("spatial"))
    rng = np.random.default_rng(0)
    rgb = rng.random((FWD_B, FWD_H, FWD_W, 3)).astype(np.float32)
    radar = np.where(rng.random((FWD_B, FWD_H, FWD_W, 1)) < 0.02,
                     rng.random((FWD_B, FWD_H, FWD_W, 1)) * 50,
                     0.0).astype(np.float32)
    np.savez(os.path.join(root, "fwd.npz"), rgb=rgb, radar=radar)
    jax_fwd, weights = {}, {}
    for decoder in DECODERS:
        jm, _ = jax_create_model(MULTI, decoder=decoder,
                                 output_size=(FWD_H, FWD_W))
        v = random_jax_variables(jm, (jnp.asarray(rgb[:1]),
                                      jnp.asarray(radar[:1])), seed=11)
        like = create_model(MULTI, device="cpu", decoder=decoder,
                            output_size=(FWD_H, FWD_W))[0].state_dict()
        weights[decoder] = state_dict_from_jax_variables(v, like=like)
        jax_fwd[decoder] = (jm, v)
    torch.save(weights, os.path.join(root, "weights.pt"))

    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=repo,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), root], env=env,
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        # the latefusion weights, which the ranks wait for after their
        # other cases
        late_vars, late_fns = _jax_late_setup()
        like = create_model(LATE, device="cpu", decoder="deconv2",
                            output_size=(GRAD_HEIGHTS[0], GRAD_W))[0]
        late = os.path.join(root, "late.pt")
        torch.save(state_dict_from_jax_variables(
            jax.tree_util.tree_map(np.asarray, late_vars),
            like=like.state_dict()), late + ".tmp")
        os.rename(late + ".tmp", late)
        ref = {}
        for decoder, (jm, v) in jax_fwd.items():
            ref[f"forward-{decoder}"] = [np.asarray(o) for o in jax.jit(
                lambda v, a, b, jm=jm: jm.apply(v, a, b, train=False))(
                    v, jnp.asarray(rgb), jnp.asarray(radar))]
        for h, (fn, cfg) in late_fns.items():
            batch = SyntheticNuScenes(GRAD_B, spec=cfg.data.sample_spec(),
                                      seed=3).batch(range(GRAD_B))
            g, _, sums = fn(late_vars["params"], late_vars["batch_stats"],
                            {k: jnp.asarray(x) for k, x in batch.items()},
                            jax.random.PRNGKey(1))
            ref[f"grads-{h}"] = (
                {k: v.double() for k, v in state_dict_from_jax_variables(
                    {"params": jax.tree_util.tree_map(np.asarray, g)}
                ).items()}, float(sums["loss"]))
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
    yield {"root": root, "lines": lines, "ref": ref}
    shutil.rmtree(root, ignore_errors=True)


def _ranks(runs, case):
    got = runs["lines"][case]
    assert sorted(got) == list(range(WORLD)), case
    return [got[r] for r in range(WORLD)]


@pytest.mark.parametrize("space", SPACES)
def test_mesh_layout(runs, space):
    """Rank r sits at (r // S, r % S) of a (world // S, S) mesh."""
    for r, line in enumerate(_ranks(runs, f"mesh-{space}")):
        assert line["axes"] == ["data", "space"]
        assert line["shape"] == [WORLD // space, space]
        assert line["data"] == [WORLD // space, r // space]
        assert line["space"] == [space, r % space]


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("name", list(OP_CASES))
def test_op_matches_unsharded(runs, name, space):
    """Output slab, input gradient and (summed over ranks) weight gradient
    of the op on slabs equal the op on the whole tensor in float64."""
    rows = []
    for line in _ranks(runs, f"op-{name}@{space}"):
        for k in ("fwd", "dx", "dw"):
            assert line.get(k, 0.0) <= OP_TOL, (k, line)
        rows.append(line["rows"])
    assert sum(r[0] for r in rows) == OP_CASES[name]["h"] * (
        WORLD // space)
    if "thin" in name and space == 4:
        # slabs thinner than the rows a window reaches past them
        assert min(r[0] for r in rows) <= 2


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("h", BN_HEIGHTS)
def test_batchnorm_over_unequal_slabs(runs, h, space):
    lines = _ranks(runs, f"bn-{h}@{space}")
    assert len({line["rows"] for line in lines}) > 1  # unequal counts
    for line in lines:
        for k in ("fwd", "dx", "dw", "stats"):
            assert line[k] <= OP_TOL, (k, line)


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("conv", CONVENTIONS)
def test_metric_conventions_over_slabs(runs, conv, space):
    for line in _ranks(runs, f"metrics-{conv}@{space}"):
        assert set(line["sums"]) == set(line["ref"])
        for k, w in line["ref"].items():
            np.testing.assert_allclose(line["sums"][k], w, rtol=METRIC_RTOL,
                                       atol=0, err_msg=k)


@pytest.mark.parametrize("decoder", DECODERS)
def test_forward_matches_jax_unsharded(runs, decoder):
    """Both heads of the (2, 2)-mesh forward against the JAX package's
    unsharded forward; every rank ran the same halo exchanges."""
    lines = _ranks(runs, f"forward-{decoder}")
    assert {line["rows"] for line in lines} == {FWD_H // 2}
    assert {line["samples"] for line in lines} == {FWD_B // 2}
    assert lines[0]["collectives"]["halo"] > 0
    assert all(line["collectives"] == lines[0]["collectives"]
               for line in lines)
    got = np.load(os.path.join(runs["root"], f"fwd-{decoder}.npz"))
    for i, want in enumerate(runs["ref"][f"forward-{decoder}"]):
        np.testing.assert_allclose(got[f"head{i}"], want, **JAX_TOL)


@pytest.mark.parametrize("h", GRAD_HEIGHTS)
def test_micro_grads_match_jax(runs, h):
    """The float32 gradients, summed over ranks, against JAX's unsharded
    micro-step: each tensor's norm ratio in 0.98-1.02 (the over-count
    GSPMD showed at H=64 would be 2-4x) and the normalized error within
    5e-2; every rank ran the same exchanges, backward ones included."""
    lines = _ranks(runs, f"grads-{h}")
    c = lines[0]["collectives"]
    assert c["halo"] > 0 and c["halo_grad"] > 0
    assert all(line["collectives"] == c for line in lines)
    want, loss = runs["ref"][f"grads-{h}"]
    for line in lines:
        np.testing.assert_allclose(line["loss"], loss, rtol=1e-4)
    got = torch.load(os.path.join(runs["root"], f"grads-{h}.pt"),
                     weights_only=True)
    assert set(got) == set(want)
    for k, w in want.items():
        if float(w.norm()) > 0:
            ratio = float(got[k].double().norm() / w.norm())
            assert RATIO[0] < ratio < RATIO[1], (k, ratio)
    errs = _norm_errs({k: v.double() for k, v in got.items()}, want)
    assert max(errs.values()) <= F32_GRAD_TOL, max(errs.items(),
                                                   key=lambda e: e[1])


@pytest.mark.parametrize("h", GRAD_HEIGHTS)
def test_micro_grads_match_one_process_in_float64(runs, h):
    line = _ranks(runs, f"grads-{h}")[0]
    assert line["f64_err"] <= F64_GRAD_TOL, (
        line["f64_worst"], line["f64_err"], line["f64_ratio"])
    lo, hi = line["f64_ratio"]
    assert 1 - F64_GRAD_TOL < lo <= hi < 1 + F64_GRAD_TOL, line
    np.testing.assert_allclose(*line["f64_loss"], rtol=1e-12)


@pytest.mark.parametrize("n", [PRED_B, 1])
def test_predictor_matches_plain(runs, n):
    """Every rank returns the whole (n, H, W) map, the plain Predictor's,
    the same on every rank; a dark and a bright sample take the two
    heads; evaluate's metrics are the plain Predictor's."""
    lines = _ranks(runs, f"predictor-b{n}")
    for line in lines:
        assert line["shape"] == [n, FWD_H, FWD_W]
        assert line["pred_err"] <= JAX_TOL["atol"] + JAX_TOL["rtol"] * \
            line["pred_scale"], line
        assert line["pred_sum"] == lines[0]["pred_sum"]
        for k, w in line["ref_metrics"].items():
            np.testing.assert_allclose(line["metrics"][k], w, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    if n > 1:
        assert 0 < lines[0]["dark"] < n


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_options_over_slabs(runs, option):
    """--remat (its recompute repeats the exchanges), --grad-accum 2,
    the uncertainty arch, --stage2-coarse and --sparsifier uar (draws for
    the global batch at full height, then slabs) run over the (2, 2) mesh:
    every rank the single process's sums, rank 0's update within 1e-9
    (1e-7 for the uncertainty arch's float32 loss weighting)."""
    lines = _ranks(runs, f"option-{option}")
    ref = lines[0]["ref_sums"]
    for line in lines:
        assert line["sums"].keys() == ref.keys()
        for k, w in ref.items():
            np.testing.assert_allclose(line["sums"][k], w, rtol=1e-6,
                                       atol=1e-9, err_msg=k)
        assert line["collectives"] == lines[0]["collectives"]
    assert lines[0]["collectives"]["halo_grad"] > 0
    tol = OPTIONS[option].get("tol", OPTION_TOL)
    assert lines[0]["update_err"] <= tol, (lines[0]["worst"],
                                           lines[0]["update_err"])


if __name__ == "__main__":
    _worker(sys.argv[1])
