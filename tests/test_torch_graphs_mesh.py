"""The steps over a process group on their graphs (radar_depth_tpu_torch/
graphs.py), on the CPU with the stand-in capture of
tests/torch_graph_capture.py.

On the card an NCCL group without a space axis captures (``graphs.wanted``);
here two gloo processes stand for it, ``wanted`` patched in each to admit
their group. Each rank runs four data-parallel train steps of the flagship
(64x96, 2 sweeps, a global batch of 2, one row per rank, the augmentation
drawn with numpy for the global batch) and three eval steps, on the graphs
and then eagerly from the same weights. Both ranks must capture at the same
call and replay at the same calls (the stand-in's capture runs the
collectives, so ranks that disagreed would block), the steps' sums, the
parameters, BN statistics and momentum must be bit-equal to the eager
steps', and ``COLLECTIVES`` must count per step under replay what it counts
eagerly. The shared key itself (no storage addresses in it over a group) is
held in this process.

Run as a script (``python tests/test_torch_graphs_mesh.py DIR``, with RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT set) this file is the worker of one
rank.
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
B = 2  # global batch
WORLD = 2
ARCH = "resnet18_multistage"
STEPS, EVALS = 4, 3
WORKER_TIMEOUT_S = 300


def _cfg():
    from radar_depth_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )

    return TrainConfig(data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
                       model=ModelConfig(arch=ARCH, decoder="upproj"),
                       batch_size=B)


def _steps(mesh, cfg, batches, augs, val, graphed):
    """STEPS train steps and EVALS eval steps on a fresh model: per call the
    sums, the ShapeGraphs' stats and the collectives; the end state."""
    from contextlib import nullcontext

    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.models import create_model, init_random
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.state import create_train_state
    from radar_depth_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )
    from tests.torch_graph_capture import Recorder

    model, spec = create_model(ARCH, device="cpu", output_size=(H, W))
    init_random(model, 0)
    state = create_train_state(model, cfg.optim, 10)
    step = make_train_step(model, spec, cfg, mesh=mesh)
    evs = make_eval_step(model, spec, cfg, mesh=mesh)
    step.graphs.capture = Recorder(lambda: [
        *model.parameters(), *model.buffers(),
        *(t for s in state.optimizer.state.values() for t in s.values())])
    evs.graphs.capture = Recorder()
    out = {"train": [], "eval": []}
    with nullcontext() if graphed else graphs.disable_graphs():
        for batch, aug in zip(batches, augs):
            pm.COLLECTIVES.clear()
            sums = step(state, pm.local_rows(batch, mesh), aug_params=aug)
            out["train"].append((sums, dict(step.graphs.stats),
                                 dict(pm.COLLECTIVES)))
        for _ in range(EVALS):
            pm.COLLECTIVES.clear()
            sums = evs(pm.local_rows(val, mesh))
            out["eval"].append((sums, dict(evs.graphs.stats),
                                dict(pm.COLLECTIVES)))
    out["state"] = ([t.detach().clone() for t in model.state_dict().values()]
                    + [s["momentum_buffer"].clone()
                       for s in state.optimizer.state.values()])
    return out


def _worker(root: str) -> None:
    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
    from radar_depth_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # native float32 convolutions
    mesh = pm.make_mesh("cpu")
    # the test's gloo group stands for an NCCL one: captured, on the CPU
    graphs.CAPTURE_DEVICES = ("cuda", "cpu")
    graphs.wanted = lambda device, plain=False, mesh=None: not plain
    spec = SampleSpec(height=H, width=W, num_sweeps=SWEEPS)
    batches = [SyntheticNuScenes(B, spec=spec, seed=s).batch(range(B))
               for s in range(STEPS)]
    rng = np.random.default_rng(3)
    augs = [(rng.uniform(1, 1.5, B).astype(np.float32),
             rng.uniform(-0.08, 0.08, B).astype(np.float32),
             rng.random(B) < 0.5,
             rng.uniform(0.6, 1.4, (B, 3)).astype(np.float32))
            for _ in range(STEPS)]
    val = SyntheticNuScenes(B, spec=spec, seed=9).batch(range(B))
    runs = {mode: _steps(mesh, _cfg(), batches, augs, val, mode == "graph")
            for mode in ("graph", "eager")}
    g, e = runs["graph"], runs["eager"]

    def equal(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    print(json.dumps({
        "rank": mesh.rank,
        **{f"{kind}_stats": [x[1] for x in g[kind]]
           for kind in ("train", "eval")},
        **{f"{kind}_collectives": [x[2] for x in g[kind]]
           for kind in ("train", "eval")},
        **{f"{kind}_collectives_eager": [x[2] for x in e[kind]]
           for kind in ("train", "eval")},
        **{f"{kind}_sums_equal": all(equal(a[0], b[0]) for a, b in zip(
            g[kind], e[kind])) for kind in ("train", "eval")},
        "state_equal": all(torch.equal(a, b)
                           for a, b in zip(g["state"], e["state"])),
        "sums": [{k: float(v) for k, v in x[0].items()} for x in g["train"]],
        "eval_sums": {k: float(v) for k, v in g["eval"][-1][0].items()}}),
        flush=True)
    pm.destroy_mesh(mesh)


@pytest.fixture(scope="module")
def ranks():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), repo],
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
    return lines


def _stats(eager, captures, replays):
    return {"eager": eager, "captures": captures, "replays": replays}


def test_ranks_capture_and_replay_at_the_same_calls(ranks):
    want = {"train": [_stats(1, 0, 0)] + [_stats(1, 1, n)
                                          for n in range(1, STEPS)],
            "eval": [_stats(1, 0, 0)] + [_stats(1, 1, n)
                                         for n in range(1, EVALS)]}
    for rank in ranks.values():
        assert rank["train_stats"] == want["train"]
        assert rank["eval_stats"] == want["eval"]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_graphed_steps_over_a_group_equal_eager_ones(ranks, kind):
    """Sums (and, of the train steps, the state) bit-equal to the eager
    steps'; the same global sums on both ranks."""
    for rank in ranks.values():
        assert rank[f"{kind}_sums_equal"] and rank["state_equal"]
    key = "sums" if kind == "train" else "eval_sums"
    assert ranks[0][key] == ranks[1][key]


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_collectives_per_step_under_replay_as_eager(ranks, kind):
    for rank in ranks.values():
        got = rank[f"{kind}_collectives"]
        assert got == rank[f"{kind}_collectives_eager"]
        assert all(c == got[0] and c.get("all_reduce", 0) > 0 for c in got)


# -------------------------------------------- the shared key, in-process


def _toy(mesh):
    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.parallel import mesh as pm
    from tests.torch_graph_capture import Recorder

    model = torch.nn.Linear(3, 4)

    def fn(x):
        pm.COLLECTIVES["all_reduce"] += 2
        return model(x) * 2

    return graphs.ShapeGraphs(fn, model, mesh=mesh, capture=Recorder(),
                              counters=lambda: []), model


def _group(backend="nccl"):
    from radar_depth_tpu_torch.parallel.mesh import DataMesh

    return DataMesh(group=object(), backend=backend)


def test_a_group_key_holds_no_address_and_a_moved_state_raises():
    """Over a group the key lacks the storage addresses; a replaced
    parameter raises at the next call at the key (never replays stale
    pointers nor runs eagerly on one rank alone), where a process without
    a group captures anew."""
    x = torch.ones(2, 3)
    g, model = _toy(_group())
    for _ in range(3):
        g(x)
    assert all(k[-1] == () for k in g._graphs)
    model.weight = torch.nn.Parameter(model.weight.detach().clone())
    with pytest.raises(RuntimeError, match="was replaced"):
        g(x)
    assert g.stats == _stats(1, 1, 2)
    alone, model = _toy(None)
    for _ in range(3):
        alone(x)
    model.weight = torch.nn.Parameter(model.weight.detach().clone())
    alone(x), alone(x)
    assert alone.stats == _stats(2, 2, 3)


def test_replays_count_the_capture_collectives():
    from radar_depth_tpu_torch.parallel import mesh as pm

    g, _ = _toy(_group())
    pm.COLLECTIVES.clear()
    counts = []
    for _ in range(4):
        g(torch.ones(2, 3))
        counts.append(pm.COLLECTIVES["all_reduce"])
    assert counts == [2, 4, 6, 8]
    assert g.stats == _stats(1, 1, 3)
    pm.COLLECTIVES.clear()


if __name__ == "__main__":
    _worker(sys.argv[1])
