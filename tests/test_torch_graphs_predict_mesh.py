"""``Predictor`` over a mesh on its CUDA graphs (radar_depth_tpu_torch/
inference.py with ``graphs.py``), on the CPU with the stand-in capture of
tests/torch_graph_capture.py, against its eager path and the JAX package.

On the card a Predictor over an NCCL mesh captures one graph per tile
shape, the gather of the whole map inside it. Here two gloo processes
stand for it, ``wanted`` patched in each to admit their group, over two
meshes of the same ranks: a data mesh of 2 (one sample a rank) and a
(data 1, space 2) mesh (a slab of rows a rank). Each rank calls
``predict`` with the same global batch three times (eager, captured,
replayed), graphed and under ``graphs.disable_graphs()``: the maps must
be bit-equal, on both ranks, the ranks must capture and replay at the same
calls, ``close`` must release the graph (before the caller destroys the
mesh: on the card a live graph holds the group's communicators), and the
graphed map is held against the JAX package's unsharded
Predictor on the same weights (converted from JAX variables) with the
tolerance of tests/test_torch_spatial.py::test_forward_matches_jax_unsharded
(rtol = atol = 1e-5).

Run as a script (``python tests/test_torch_graphs_predict_mesh.py DIR``,
with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set) this file is the
worker of one rank: it imports the port, never JAX.
"""

import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

H, W, SWEEPS = 64, 96, 2
B = 2  # the global batch: a tile of 2, one row a rank on the data mesh
WORLD = 2
MESHES = ("data", "space")
CALLS = 3
ARCH, DECODER = "resnet18_multistage", "upproj"
JAX_TOL = dict(rtol=1e-5, atol=1e-5)
WORKER_TIMEOUT_S = 300


def _serve_cfg():
    from radar_depth_tpu_torch.config import ServeConfig

    return ServeConfig(arch=ARCH, decoder=DECODER, dtype="float32",
                       height=H, width=W, num_sweeps=SWEEPS)


def _spec():
    from radar_depth_tpu_torch.data import SampleSpec

    return SampleSpec(height=H, width=W, num_sweeps=SWEEPS, lidar_points=2048)


def _worker(root: str) -> None:
    from contextlib import nullcontext

    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.parallel import mesh as pm
    from tests.torch_graph_capture import Recorder

    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False  # native float32 convolutions
    # one default group, two meshes over it
    meshes = {"data": pm.make_mesh("cpu"),
              "space": pm.make_spatial_mesh(WORLD, "cpu")}
    # the test's gloo group stands for an NCCL one: captured, on the CPU
    graphs.CAPTURE_DEVICES = ("cuda", "cpu")
    graphs.wanted = lambda device, plain=False, mesh=None: not plain
    weights = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    batch = dict(np.load(os.path.join(root, "batch.npz")))
    rank = meshes["data"].rank
    for name, mesh in meshes.items():
        out = {}
        for mode in ("graph", "eager"):
            pred = Predictor(_serve_cfg(), weights, device="cpu", mesh=mesh)
            pred.graphs.capture = Recorder()
            maps, stats = [], []
            with nullcontext() if mode == "graph" else graphs.disable_graphs():
                for _ in range(CALLS):
                    maps.append(pred.predict(batch))
                    stats.append(dict(pred.graphs.stats))
            out[mode] = (maps, stats)
            if mode == "graph":
                held = len(pred.graphs._graphs)
                pred.close()  # releases the graphs; the mesh is the caller's
                released = held == 1 and not pred.graphs._graphs
        np.save(os.path.join(root, f"{name}-{rank}.npy"), out["graph"][0][-1])
        print(json.dumps({
            "mesh": name, "rank": rank, "shape": list(mesh.shape),
            "stats": out["graph"][1],
            "equal": all(np.array_equal(g, e) for g, e in zip(
                out["graph"][0], out["eager"][0])),
            "calls_equal": all(np.array_equal(m, out["graph"][0][0])
                               for m in out["graph"][0]),
            "released_on_close": released}), flush=True)
    pm.destroy_mesh(meshes["data"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the weights and batch, start the two ranks, run the JAX
    Predictor while they run."""
    import jax.numpy as jnp

    from radar_depth_tpu.config import DataConfig, ModelConfig, TrainConfig
    from radar_depth_tpu.inference import Predictor as JaxPredictor
    from radar_depth_tpu_torch.convert import state_dict_from_jax_variables
    from radar_depth_tpu_torch.data import SyntheticNuScenes
    from tests.test_torch_models import random_jax_variables

    root = str(tmp_path_factory.mktemp("predict_mesh"))
    jpred = JaxPredictor(TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
        model=ModelConfig(arch=ARCH, decoder=DECODER)), None, None)
    rgb = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = random_jax_variables(jpred.model, (rgb, rgb[..., :1]),
                                     seed=11)
    jpred.params, jpred.batch_stats = (variables["params"],
                                       variables["batch_stats"])
    torch.save(state_dict_from_jax_variables(variables),
               os.path.join(root, "weights.pt"))
    batch = SyntheticNuScenes(B, spec=_spec(), seed=4).batch(range(B))
    np.savez(os.path.join(root, "batch.npz"), **batch)
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
        want = jpred.predict(batch)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = {}
    for rank, ((out, err), p) in enumerate(zip(outs, procs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}\n{err[-4000:]}"
        for x in out.splitlines():
            if x.startswith("{"):
                rec = json.loads(x)
                lines[(rec["mesh"], rec["rank"])] = rec
    assert sorted(lines) == [(m, r) for m in MESHES for r in range(WORLD)]
    maps = {k: np.load(os.path.join(root, f"{k[0]}-{k[1]}.npy"))
            for k in lines}
    yield {"lines": lines, "maps": maps, "jax": np.asarray(want)}
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_predictor_graph_equals_eager(ranks, mesh):
    """Every call's map bit-equal to the eager one, on both ranks; both
    ranks captured at call 2 and replayed at call 3; the mesh's layout."""
    want_stats = [{"eager": 1, "captures": 0, "replays": 0},
                  {"eager": 1, "captures": 1, "replays": 1},
                  {"eager": 1, "captures": 1, "replays": 2}]
    for r in range(WORLD):
        line = ranks["lines"][(mesh, r)]
        assert line["shape"] == ([WORLD] if mesh == "data" else [1, WORLD])
        assert line["equal"] and line["calls_equal"]
        assert line["released_on_close"]
        assert line["stats"] == want_stats
    assert np.array_equal(ranks["maps"][(mesh, 0)], ranks["maps"][(mesh, 1)])


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_predictor_graph_matches_jax_unsharded(ranks, mesh):
    """The replayed map against the JAX package's Predictor on one device
    over the same batch and weights."""
    got = ranks["maps"][(mesh, 0)]
    assert got.shape == (B, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, ranks["jax"], **JAX_TOL)


if __name__ == "__main__":
    _worker(sys.argv[1])
