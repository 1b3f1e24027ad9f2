"""The spatial paths on their CUDA graphs (radar_depth_tpu_torch/graphs.py
over a mesh with a space axis), on the CPU with the stand-in capture of
tests/torch_graph_capture.py.

On the card an NCCL mesh with a space axis captures (``graphs.wanted``):
the halo exchanges, the BN statistics' all-reduces and the gathers of the
whole map run inside the graph. Here two gloo processes on a (data 1,
space 2) mesh stand for it, ``wanted`` patched in each to admit their
group. Each rank runs, graphed and then eagerly from the same weights:
four spatial train steps of the flagship (64x96, 2 sweeps, a global batch
of 2, the augmentation drawn with numpy), three spatial eval steps and
three ``Predictor.predict`` calls over the mesh. Both ranks must capture
at the same call and replay at the same calls (the stand-in's capture and
replay run the exchanges, so ranks that disagreed would block); the sums,
the state after the steps and the maps must be bit-equal to the eager
ones; and a replay must count the ``halo`` and ``halo_grad`` exchanges
and ``HALO["bytes"]`` of an eager call, and no host seconds (those come
from eager calls only). ``graphs.wanted`` itself is held in this process,
on ``DataMesh`` objects built by hand.

Run as a script (``python tests/test_torch_graphs_spatial.py DIR``, with
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set) this file is the worker
of one rank.
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
B = 2  # global batch: the mesh's one data index holds both samples
WORLD = SPACE = 2
ARCH = "resnet18_multistage"
CALLS = {"train": 4, "eval": 3, "predict": 3}
WORKER_TIMEOUT_S = 300


def _cfg():
    from radar_depth_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )

    return TrainConfig(data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
                       model=ModelConfig(arch=ARCH, decoder="upproj",
                                         blend_tau=0.3),
                       batch_size=B)


def _counted(fn):
    """``fn()``, and what it added to the collectives and the halo
    counters."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp

    pm.COLLECTIVES.clear()
    sp.HALO.clear()
    out = fn()
    return out, {"collectives": dict(pm.COLLECTIVES),
                 "halo_bytes": sp.HALO["bytes"],
                 "halo_seconds": sp.HALO["seconds"]}


def _run(mesh, cfg, batches, augs, val, graphed):
    """Per kind of call, per call: (result, graph stats, counts); and the
    model's and optimizer's state after the train steps."""
    from contextlib import nullcontext

    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )
    from tests.torch_graph_capture import Recorder

    model, spec = create_model(ARCH, device="cpu", output_size=(H, W),
                               decoder="upproj")
    init_random(model, 0)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, cfg.optim, 10)
    step = make_train_step(model, spec, cfg, mesh=mesh)
    evs = make_eval_step(model, spec, cfg, mesh=mesh)
    pred = Predictor(serve_config(cfg), weights, device="cpu", mesh=mesh)
    step.graphs.capture = Recorder(lambda: [
        *model.parameters(), *model.buffers(),
        *(t for s in state.optimizer.state.values() for t in s.values())])
    evs.graphs.capture = Recorder()
    pred.graphs.capture = Recorder()
    calls = {
        "train": [lambda b=b, a=a: step(state, b, aug_params=a)
                  for b, a in zip(batches, augs)],
        "eval": [lambda: evs(val)] * CALLS["eval"],
        "predict": [lambda: pred.predict(val)] * CALLS["predict"]}
    owners = {"train": step, "eval": evs, "predict": pred}
    out = {}
    with nullcontext() if graphed else graphs.disable_graphs():
        for kind, fns in calls.items():
            out[kind] = []
            for fn in fns:
                result, counts = _counted(fn)
                out[kind].append((result, dict(owners[kind].graphs.stats),
                                  counts))
            if kind == "train":
                out["state"] = (
                    [t.detach().clone() for t in model.state_dict().values()]
                    + [s["momentum_buffer"].clone()
                       for s in state.optimizer.state.values()])
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in b)
    return np.array_equal(a, b) and a.dtype == b.dtype


def _worker(root: str) -> None:
    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # native float32 convolutions
    mesh = pm.make_spatial_mesh(SPACE, "cpu")
    # the test's gloo group stands for an NCCL one: captured, on the CPU
    graphs.CAPTURE_DEVICES = ("cuda", "cpu")
    graphs.wanted = lambda device, plain=False, mesh=None: not plain
    spec = SampleSpec(height=H, width=W, num_sweeps=SWEEPS,
                      lidar_points=2048)
    batches = [SyntheticNuScenes(B, spec=spec, seed=s).batch(range(B))
               for s in range(CALLS["train"])]
    rng = np.random.default_rng(3)
    augs = [(rng.uniform(1, 1.5, B).astype(np.float32),
             rng.uniform(-0.08, 0.08, B).astype(np.float32),
             rng.random(B) < 0.5,
             rng.uniform(0.6, 1.4, (B, 3)).astype(np.float32))
            for _ in range(CALLS["train"])]
    val = SyntheticNuScenes(B, spec=spec, seed=9).batch(range(B))
    runs = {mode: _run(mesh, _cfg(), batches, augs, val, mode == "graph")
            for mode in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]
    line = {"rank": mesh.rank, "shape": list(mesh.shape),
            "state_equal": all(torch.equal(a, b)
                               for a, b in zip(g["state"], e["state"]))}
    for kind in CALLS:
        line[kind] = {
            "stats": [x[1] for x in g[kind]],
            "counts": [x[2] for x in g[kind]],
            "counts_eager": [x[2] for x in e[kind]],
            "equal": all(_equal(a[0], b[0])
                         for a, b in zip(g[kind], e[kind]))}
    line["sums"] = [{k: float(v) for k, v in x[0].items()}
                    for x in g["train"]]
    maps = g["predict"][-1][0]
    line["map_shape"] = list(maps.shape)
    np.save(os.path.join(root, f"map-{mesh.rank}.npy"), maps)
    print(json.dumps(line), flush=True)
    pm.destroy_mesh(mesh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("graphs_spatial"))
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), root],
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), PYTHONPATH=repo, OMP_NUM_THREADS="1"),
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = {}
    for rank, ((out, err), p) in enumerate(zip(outs, procs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}\n{err[-4000:]}"
        rec = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
        lines[rec["rank"]] = rec
    assert sorted(lines) == list(range(WORLD))
    assert all(r["shape"] == [1, SPACE] for r in lines.values())
    return {"lines": lines, "root": root}


def _stats(eager, captures, replays):
    return {"eager": eager, "captures": captures, "replays": replays}


@pytest.mark.parametrize("kind", list(CALLS))
def test_ranks_capture_and_replay_at_the_same_calls(ranks, kind):
    """Call 1 eager on both ranks, call 2 captured (and replayed), later
    calls replayed, on both ranks alike."""
    n = CALLS[kind]
    want = [_stats(1, 0, 0)] + [_stats(1, 1, i) for i in range(1, n)]
    for rank in ranks["lines"].values():
        assert rank[kind]["stats"] == want


@pytest.mark.parametrize("kind", list(CALLS))
def test_spatial_graphs_equal_eager(ranks, kind):
    """Sums (and after the train steps the parameters, BN statistics and
    momentum) and maps bit-equal to the eager path's; every rank the same
    global sums and the same whole map."""
    lines = ranks["lines"]
    for rank in lines.values():
        assert rank[kind]["equal"]
        assert rank["state_equal"]
    assert lines[0]["sums"] == lines[1]["sums"]
    maps = [np.load(os.path.join(ranks["root"], f"map-{r}.npy"))
            for r in range(WORLD)]
    assert maps[0].shape == (B, H, W)
    assert np.array_equal(maps[0], maps[1])


@pytest.mark.parametrize("kind", list(CALLS))
def test_a_replay_counts_the_halos_of_an_eager_call(ranks, kind):
    """Per call, graphed as eager: the collectives by kind (``halo``, and
    ``halo_grad`` in the train step) and the halo bytes; host seconds from
    the eager calls alone (call 1 of the graphed path, every eager call)."""
    for rank in ranks["lines"].values():
        got, want = rank[kind]["counts"], rank[kind]["counts_eager"]
        for g, w in zip(got, want):
            assert g["collectives"] == w["collectives"] == got[0][
                "collectives"]
            assert g["halo_bytes"] == w["halo_bytes"] > 0
            assert w["halo_seconds"] > 0
        assert got[0]["collectives"]["halo"] > 0
        assert ("halo_grad" in got[0]["collectives"]) == (kind == "train")
        assert got[0]["halo_seconds"] > 0
        assert all(g["halo_seconds"] == 0 for g in got[1:])


# ------------------------------------------------- graphs.wanted, in-process


def _mesh(backend):
    from radar_depth_tpu_torch.parallel.mesh import DataMesh

    return DataMesh(group=object(), backend=backend,
                    axis_names=("data", "space"), shape=(1, SPACE),
                    space_size=SPACE)


@pytest.mark.parametrize("case,want", [
    (dict(device="cuda", backend="nccl"), True),
    (dict(device="cuda", backend="gloo"), False),
    (dict(device="cpu", backend="nccl"), False),
    (dict(device="cuda", backend="nccl", plain=True), False)])
def test_wanted_over_a_spatial_mesh(case, want):
    """A mesh with a space axis captures on the card over NCCL, with the
    kernels; over gloo, on the CPU or with ``plain`` it stays eager."""
    from radar_depth_tpu_torch import graphs

    assert graphs.wanted(case["device"], case.get("plain", False),
                         _mesh(case["backend"])) == want


if __name__ == "__main__":
    _worker(sys.argv[1])
