"""The port's data mesh (radar_depth_tpu_torch/parallel/mesh.py) in one
process: pad_batch_to against the JAX package's, local_rows, the batch-size
checks, the world-1 mesh without a process group (the Trainer makes none
without RANK/WORLD_SIZE), the spatial mesh's refusal of a world it does
not divide, and a gloo group of
one rank, whose collectives each return their input so that BN, the losses
and the metrics through it give the bits of the code without a group. The
2-rank numbers are tests/test_torch_parallel_steps.py's and
tests/test_torch_parallel_trainer.py's."""

import contextlib
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from radar_depth_tpu.parallel.mesh import pad_batch_to as jax_pad_batch_to
from radar_depth_tpu_torch import config
from radar_depth_tpu_torch.metrics import compute_metric_sums
from radar_depth_tpu_torch.models.layers import BatchNorm, use_mesh
from radar_depth_tpu_torch.objectives import (
    masked_l1_loss,
    multistage_uncertainty_loss,
)
from radar_depth_tpu_torch.parallel import mesh as pm
from radar_depth_tpu_torch.train.loop import Trainer

DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (n, 4, 6, 3), dtype=np.uint8),
            "lidar_depth": rng.uniform(0, 60, (n, 4, 6)).astype(np.float32),
            "lidar_valid": rng.uniform(size=(n, 9)) < 0.5,
            "radar_points": rng.normal(size=(n, 2, 5, 3)).astype(np.float32)}


@pytest.mark.parametrize("n", [1, 3, 4])
def test_pad_batch_to_matches_jax(n):
    """Bit-equal to the JAX package's on the same numpy batch, the true
    count returned beside it; a full batch comes back as it is."""
    batch = _batch(n)
    got, count = pm.pad_batch_to(batch, 4)
    want, jcount = jax_pad_batch_to(batch, 4)
    assert count == jcount == n
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape[0] == 4
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if n == 4:
        assert got is batch
    else:
        assert not got["lidar_depth"][n:].any()
        assert not got["lidar_valid"][n:].any()
        np.testing.assert_array_equal(got["image"][n:],
                                      np.repeat(batch["image"][-1:], 4 - n, 0))


def test_local_rows():
    """Rank r of 2 takes rows [2r, 2r+2) of dim 0, of dim 1 under grad
    accumulation, of arrays, tensors and tuples; world 1 returns the batch
    itself; None stays None; rows that do not split raise."""
    batch = _batch(4)
    stacked = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    for rank in range(2):
        mesh = pm.DataMesh(rank=rank, world=2)
        rows = pm.local_rows(batch, mesh)
        acc = pm.local_rows(stacked, mesh, accum=True)
        for k, v in batch.items():
            np.testing.assert_array_equal(rows[k], v[2 * rank:2 * rank + 2])
            np.testing.assert_array_equal(acc[k],
                                          stacked[k][:, rank:rank + 1])
        t = torch.arange(8).reshape(4, 2)
        scale, flip = pm.local_rows((t, t[:, 0] > 2), mesh)
        assert torch.equal(scale, t[2 * rank:2 * rank + 2])
        assert torch.equal(flip, (t[:, 0] > 2)[2 * rank:2 * rank + 2])
        assert pm.local_rows(None, mesh) is None
    assert pm.local_rows(batch, pm.DataMesh()) is batch
    assert pm.local_rows(batch, None) is batch
    with pytest.raises(ValueError, match="do not split over 3 ranks"):
        pm.local_rows(batch, pm.DataMesh(world=3))


def test_batch_size_divisibility_errors():
    """The JAX Trainer's two errors: batch_size and eval_batch_size must be
    multiples of the world size (0 = unset passes)."""
    mesh = pm.DataMesh(world=2)
    pm.check_batch_sizes(mesh, batch_size=4, eval_batch_size=0)
    with pytest.raises(ValueError, match="batch_size=3 is not divisible by "
                       "the 2-rank data mesh"):
        pm.check_batch_sizes(mesh, batch_size=3, eval_batch_size=4)
    with pytest.raises(ValueError, match="eval_batch_size=5 is not divisible"):
        pm.check_batch_sizes(mesh, batch_size=4, eval_batch_size=5)


def test_no_environment_no_group(monkeypatch, tmp_path):
    """Without RANK/WORLD_SIZE: a world-1 mesh with no group and nothing
    initialised, also inside the Trainer; the default platform needs a
    card; a world size without a group is refused."""
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = pm.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.device.type) == (
        0, 1, None, "cpu")
    assert not pm.is_distributed(mesh) and not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            pm.make_mesh()
    cfg = config.parse_command(
        ["--arch", "resnet18_multistage", "--platform", "cpu", "--height",
         "64", "--width", "96", "--num-train", "4", "--num-val", "2", "-b",
         "2", "--output-dir", str(tmp_path / "out")])
    tr = Trainer(cfg)
    try:
        assert tr.mesh.group is None and not dist.is_initialized()
        bns = [m for m in tr.model.modules() if isinstance(m, BatchNorm)]
        assert bns and all(m.mesh is None for m in bns)
    finally:
        tr.close()
    monkeypatch.setenv("WORLD_SIZE", "2")  # without RANK: no group
    with pytest.raises(ValueError, match="without a process group"):
        pm.make_mesh("cpu")


def test_spatial_mesh_is_not_ported():
    """The spatial mesh is ported (tests/test_torch_spatial.py): without a
    process group the world of 1 does not split over 2 space ranks, and
    spatial_constraint without a space axis returns its batch."""
    with pytest.raises(ValueError, match="multiple of 2 ranks"):
        pm.make_spatial_mesh(2, "cpu")
    from radar_depth_tpu_torch.parallel import spatial_constraint

    batch = {"rgb": torch.zeros(1, 4, 6, 3)}
    assert spatial_constraint(batch, None) is batch


def test_collectives_without_a_group_are_identities():
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pm.COLLECTIVES.clear()
    ts = [torch.ones(2), torch.zeros(3)]
    assert all(a is b for a, b in zip(pm.all_reduce_sum(ts, None), ts))
    assert pm.broadcast_module(model, pm.DataMesh()) is model
    assert pm.assert_replicated(model, None)
    pm.DataMesh().barrier()
    assert not pm.COLLECTIVES
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_isolation_walk_imports_the_mesh():
    from tests.test_torch_isolation import _modules

    mods = _modules()
    assert "radar_depth_tpu_torch.parallel" in mods
    assert "radar_depth_tpu_torch.parallel.mesh" in mods


# -------------------------------------------------- a gloo group of one


@pytest.fixture(scope="module")
def group_of_one():
    """A 1-rank gloo group made as torchrun's environment makes it; the
    environment is restored once the group exists."""
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
            mp.setenv(k, v)
        mp.delenv("LOCAL_RANK", raising=False)
        mesh = pm.make_mesh("cpu")
    try:
        yield mesh
    finally:
        pm.destroy_mesh(mesh)
    assert not dist.is_initialized()


def test_group_of_one_mesh(group_of_one):
    mesh = group_of_one
    assert (mesh.rank, mesh.world, mesh.backend, mesh.created) == (
        0, 1, "gloo", True)
    assert pm.is_distributed(mesh)
    two_d = pm.make_mesh_2d(1, 1, platform="cpu")
    assert (two_d.axis_names, two_d.shape, two_d.group) == (
        ("replica", "data"), (1, 1), mesh.group)
    assert not two_d.created
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        pm.make_mesh_2d(2, 1, platform="cpu")


def test_group_of_one_collectives(group_of_one):
    """all_reduce_sum returns each input in its shape and dtype through one
    collective; the differentiable all-reduce passes values and gradients
    through; broadcast and the replica check leave the model alone."""
    mesh = group_of_one
    pm.COLLECTIVES.clear()
    a = torch.randn(2, 3)
    b = torch.tensor(7, dtype=torch.int64)
    ra, rb = pm.all_reduce_sum([a, b], mesh, dtype=torch.float64)
    assert torch.equal(ra, a) and torch.equal(rb, b) and rb.dtype == b.dtype
    x = torch.randn(4, requires_grad=True)
    y = pm.all_reduce_grad(x, mesh)
    (g,) = torch.autograd.grad((y * torch.arange(4.0)).sum(), x)
    assert torch.equal(y, x) and torch.equal(g, torch.arange(4.0))
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pm.broadcast_module(model, mesh)
    assert pm.assert_replicated(model, mesh)
    mesh.barrier()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert pm.COLLECTIVES == {"all_reduce": 4, "broadcast": 2, "barrier": 1}


def test_group_of_one_batchnorm_bit_equal(group_of_one):
    """Train-mode BN through the group: output, input and parameter
    gradients and running statistics bit-equal to BN without it, with two
    all-reduces forward and one backward."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 3, 4, generator=g) * 3 + 1
    up = torch.randn(2, 5, 3, 4, generator=g)
    out = []
    for mesh in (None, group_of_one):
        bn = BatchNorm(5)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2, 5))
            bn.bias.copy_(torch.linspace(-1, 1, 5))
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
        use_mesh(bn, mesh)
        xi = x.clone().requires_grad_(True)
        pm.COLLECTIVES.clear()
        y = bn.train()(xi, relu=True)
        grads = torch.autograd.grad((y * up).sum(), (xi, bn.weight, bn.bias))
        out.append((y, grads, bn.running_mean.clone(), bn.running_var.clone(),
                    dict(pm.COLLECTIVES)))
    (y0, g0, m0, v0, c0), (y1, g1, m1, v1, c1) = out
    assert torch.equal(y0, y1) and torch.equal(m0, m1) and torch.equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert c0 == {} and c1 == {"all_reduce": 3}


@pytest.mark.parametrize("convention", ["batch", "sample"])
def test_group_of_one_losses_and_metrics_bit_equal(group_of_one, convention):
    """The masked losses (the uncertainty form too) and the metric sums
    through the group: the bits of the code without it."""
    rng = np.random.default_rng(4)
    pred = torch.from_numpy(rng.uniform(1, 60, (3, 8, 12, 1)).astype(
        np.float32)).requires_grad_(True)
    target = torch.from_numpy(rng.uniform(1, 60, (3, 8, 12, 1)).astype(
        np.float32))
    target[torch.from_numpy(rng.uniform(size=(3, 8, 12, 1)) < 0.6)] = 0.0
    log_var = torch.tensor([0.3, -0.2], requires_grad=True)
    res = []
    for mesh in (None, group_of_one):
        l1 = masked_l1_loss(pred, target, mesh)
        unc = multistage_uncertainty_loss((pred, pred * 1.1), log_var,
                                          target, mesh=mesh)
        grads = torch.autograd.grad(l1 + unc, (pred, log_var))
        sums = compute_metric_sums(pred.detach(), target, convention, mesh)
        res.append((l1, unc, grads, sums))
    (a, b, ga, sa), (c, d, gc, sc) = res
    assert torch.equal(a, c) and torch.equal(b, d)
    assert all(torch.equal(x, y) for x, y in zip(ga, gc))
    assert set(sa) == set(sc)
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k


@pytest.mark.parametrize("sparsifier", ["none", "uar"])
def test_draws_are_the_global_batch_rows(sparsifier):
    """Over a mesh, the step draws its augmentation parameters (or a
    sparsifier's uniforms) for the global batch from the generator every
    rank seeds alike, and each rank keeps its rows: rank r's draws are rows
    [2r, 2r+2) of the single-process draws over 4 samples. Given draws are
    the global batch's and are sliced the same way."""
    from radar_depth_tpu_torch.config import DataConfig, TrainConfig
    from radar_depth_tpu_torch.ops.augment import sample_affine_params
    from radar_depth_tpu_torch.train.step import (
        _global_draws,
        make_preprocess_config,
    )

    pre = make_preprocess_config(TrainConfig(data=DataConfig(
        height=8, width=12, sparsifier=sparsifier)))
    rows = {"image": np.zeros((2, 8, 12, 3), np.uint8)}
    g = torch.Generator().manual_seed(7)
    want = (torch.rand((4, 8, 12), generator=g) if sparsifier == "uar"
            else sample_affine_params(g, pre.augment, 4))
    for rank in range(2):
        mesh = pm.DataMesh(rank=rank, world=2)
        gen = torch.Generator().manual_seed(7)
        aug, u = _global_draws(rows, pre, mesh, "cpu", None, gen, None, False)
        given = _global_draws(rows, pre, mesh, "cpu",
                              None if sparsifier == "uar" else want, None,
                              want if sparsifier == "uar" else None, False)
        sl = slice(2 * rank, 2 * rank + 2)
        if sparsifier == "uar":
            assert aug is None and torch.equal(u, want[sl])
            assert torch.equal(given[1], want[sl])
        else:
            assert u is None
            for got, giv, w in zip(aug, given[0], want):
                assert torch.equal(got, w[sl]) and torch.equal(giv, w[sl])
