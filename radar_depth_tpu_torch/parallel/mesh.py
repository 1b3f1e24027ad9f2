"""The data mesh of the port over ``torch.distributed``, mirroring
``radar_depth_tpu/parallel/mesh.py``.

Under GSPMD the JAX train step is one graph over the global batch, so its
train-mode BN normalizes with global-batch statistics, its masked losses
divide by the global count of valid pixels and its pooled metrics take their
square roots over the global batch. The port runs one process per rank
(``torchrun``), each holding a replica of the model and its own rows of the
global batch (``local_rows``), and makes those three reductions global
explicitly (``global_moments``, ``all_reduce_sum``); every rank
differentiates its share ``L_r`` of the loss (``sum_r L_r`` is the JAX
loss) and the gradients are summed over ranks once per optimizer step.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: they are what
gloo supports for CUDA tensors as well as NCCL, so the same path runs over
NCCL on the cards (the default), over gloo on the CPU (``platform="cpu"``)
and over gloo with two ranks on one card (NCCL refuses that). Every call
counts in ``COLLECTIVES``.

Without a distributed environment (no ``RANK`` / ``WORLD_SIZE``, as
``torchrun`` sets them) ``make_mesh`` returns a world-1 mesh with no process
group: the steps then run exactly their single-process code, with no
collective.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from radar_depth_tpu_torch.device import resolve_device

# a rank that dies leaves the others blocked in a collective: the group
# gives up after this long (torchrun tears the ranks down before that)
DEFAULT_TIMEOUT_S = 1800.0

# calls by kind since the last reset, in this process
COLLECTIVES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in the data mesh. ``group`` is the process
    group of the collectives, None for a world-1 mesh without one.
    ``axis_names`` and ``shape`` describe the layout (``("data",)`` or
    ``("replica", "data")``); the batch splits over all axes and every
    reduction spans the whole world, so the layout does not change the
    numbers."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = (1,)
    backend: Optional[str] = None
    created: bool = False  # make_mesh initialised the default group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if not is_distributed(self):
            return
        COLLECTIVES["barrier"] += 1
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def is_distributed(mesh: Optional[DataMesh]) -> bool:
    """True when ``mesh`` has a process group: its steps issue collectives
    (also at world 1, where each one returns its input)."""
    return mesh is not None and mesh.group is not None


def make_mesh(platform: str = "default", *, backend: Optional[str] = None,
              axis: str = "data") -> DataMesh:
    """The 1-axis data mesh of this process, from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).

    Without ``RANK`` and ``WORLD_SIZE`` (and no default process group): a
    world-1 mesh with no group on ``cuda:LOCAL_RANK`` (the card; it raises
    without one) or, with ``platform="cpu"``, the CPU. With them: the
    default process group over NCCL on ``cuda:LOCAL_RANK``
    (``torch.cuda.set_device`` first) or over gloo on the CPU, initialised
    from the environment unless it exists already; a world of 1 makes a
    group too, so its collectives run.

    ``backend`` overrides NCCL on the card, for two ranks on one card over
    gloo (a check: NCCL refuses it); nothing falls back to it."""
    env = os.environ
    distributed = dist.is_initialized() or (
        "RANK" in env and "WORLD_SIZE" in env)
    local = int(env.get("LOCAL_RANK", 0))
    dev = torch.device("cpu") if platform == "cpu" else resolve_device()
    if not distributed:
        world = int(env.get("WORLD_SIZE", 1))
        if world != 1:
            raise ValueError(f"world size {world} without a process group")
        return DataMesh(device=dev, axis_names=(axis,))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend runs on CUDA devices only")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    created = not dist.is_initialized()
    if created:
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    elif dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()}, not {backend}")
    world = dist.get_world_size()
    return DataMesh(rank=dist.get_rank(), world=world, device=dev,
                    group=dist.group.WORLD, axis_names=(axis,),
                    shape=(world,), backend=backend, created=created)


def make_mesh_2d(outer: int, inner: int, platform: str = "default",
                 **kw) -> DataMesh:
    """The (replica, data) layout of ``outer * inner`` ranks (JAX's
    ``make_mesh_2d``): the batch splits over both axes, rank r holding the
    r-th share, and every reduction spans the world, as the JAX step's
    does. ``kw`` goes to ``make_mesh``."""
    mesh = make_mesh(platform, **kw)
    if outer * inner != mesh.world:
        destroy_mesh(mesh)
        raise ValueError(f"make_mesh_2d({outer}, {inner}) needs "
                         f"{outer * inner} ranks, have {mesh.world}")
    return dataclasses.replace(mesh, axis_names=("replica", "data"),
                               shape=(outer, inner))


def make_spatial_mesh(spatial: int, *args, **kw):
    raise NotImplementedError(
        f"spatial partitioning (--spatial {spatial}) is not ported to "
        "radar_depth_tpu_torch (ROADMAP Queue A item 5)")


def spatial_constraint(prepared: Dict, mesh):
    raise NotImplementedError(
        "spatial partitioning (--spatial) is not ported to "
        "radar_depth_tpu_torch (ROADMAP Queue A item 5)")


def destroy_mesh(mesh: Optional[DataMesh]) -> None:
    """Destroy the default process group if ``make_mesh`` made it."""
    if mesh is not None and mesh.created and dist.is_initialized():
        dist.destroy_process_group()


def check_batch_sizes(mesh: DataMesh, **sizes: int) -> None:
    """The JAX Trainer's check: each global batch size (0 = unset) must
    split evenly over the ranks."""
    for name, bs in sizes.items():
        if bs and bs % mesh.world != 0:
            raise ValueError(
                f"{name}={bs} is not divisible by the {mesh.world}-rank "
                f"data mesh — pick a multiple of {mesh.world} (each rank "
                "takes an equal share of the batch)")


# -------------------------------------------------------------- batches


def local_rows(batch, mesh: Optional[DataMesh], accum: bool = False):
    """This rank's rows of a global batch: rows ``[r*b, (r+1)*b)`` of dim 0
    (dim 1 with ``accum``: leaves stacked (grad_accum, batch, ...)), b the
    global rows over the world size; the counterpart of
    ``shard_batch(process_local=True)``. ``batch`` is a dict, list or tuple
    of arrays or tensors, or one of them (None stays None). World 1 returns
    ``batch``."""
    if mesh is None or mesh.world == 1 or batch is None:
        return batch
    if isinstance(batch, dict):
        return {k: local_rows(v, mesh, accum) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_rows(v, mesh, accum) for v in batch)
    dim = 1 if accum else 0
    n = batch.shape[dim]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    b = n // mesh.world
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return batch[rows] if dim == 0 else batch[:, rows]


def pad_batch_to(batch: Dict, size: int):
    """Pad a ragged final batch of numpy arrays up to ``size`` rows by
    repeating the last sample, with ``lidar_depth`` and ``lidar_valid``
    zeroed on the padding so it carries no valid target (the metric sums
    skip it). Returns (batch, true row count). The JAX package's
    ``pad_batch_to``."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], size - n, axis=0)
        if k in ("lidar_depth", "lidar_valid"):
            pad = np.zeros_like(pad)  # padding contributes no valid GT
        out[k] = np.concatenate([v, pad], axis=0)
    return out, n


# ---------------------------------------------------------- collectives


def _all_reduce(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh],
                   dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The sums over ranks of ``tensors`` (no gradient), through one buffer
    in ``dtype`` (default: the first tensor's) and one collective; each
    comes back in its own shape and dtype. Without a group: ``tensors``."""
    if not is_distributed(mesh):
        return list(tensors)
    dtype = dtype or tensors[0].dtype
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    _all_reduce(flat, mesh)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum_r x_r on every rank. Rank r's loss depends on its copy of
    y, so dL/dx_r = sum_q dL_q/dy: the backward is the same SUM all-reduce
    of the upstream gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.detach().clone(
            memory_format=torch.contiguous_format), ctx.mesh), None


def all_reduce_grad(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Differentiable SUM all-reduce of ``x`` over ``mesh``."""
    return _AllReduceSum.apply(x, mesh)


class _GlobalMoments(torch.autograd.Function):
    """``global_moments`` in one autograd node: two all-reduces forward,
    one backward.

    Forward, with w = 1/world: m = w sum_q mean_q, then
    v = w sum_q (var_q + (mean_q - m)^2). Backward, G_m and G_v the sums
    over ranks of the upstream gradients of m and v (one all-reduce of the
    pair): dvar_r = w G_v and dmean_r = w (G_m + 2 (mean_r - m) G_v). The
    path of m through v is left out: its gradient is
    -2 w G_v sum_q (mean_q - m), which is 0."""

    @staticmethod
    def forward(ctx, mean, var, mesh):
        w = 1.0 / mesh.world
        gmean = _all_reduce(mean * w, mesh)
        dev = mean - gmean
        gvar = _all_reduce(torch.addcmul(var, dev, dev) * w, mesh)
        ctx.save_for_backward(dev)
        ctx.w, ctx.mesh = w, mesh
        return gmean, gvar

    @staticmethod
    def backward(ctx, g_mean, g_var):
        dev, = ctx.saved_tensors
        g_mean, g_var = _all_reduce(torch.stack([g_mean, g_var]),
                                    ctx.mesh).unbind(0)
        d_mean = torch.addcmul(g_mean, dev, g_var, value=2.0) * ctx.w
        return d_mean, g_var * ctx.w, None


def global_moments(mean: torch.Tensor, var: torch.Tensor, mesh: DataMesh):
    """Global-batch (mean, biased variance) from each rank's own, every
    rank holding the same number of rows (``local_rows``): the mean of the
    ranks' means, then the mean of ``var_r + (mean_r - mean)^2`` over ranks,
    which is sum (x - mean)^2 / N over the global batch; differentiable,
    through three all-reduces (two forward, one backward). Each rank's
    moments come from its own two-pass ``var_mean``, so the variance keeps
    the digits of a two-pass one, and at world 1 the result and its
    gradients have the bits of the rank's own moments."""
    return _GlobalMoments.apply(mean, var, mesh)


# ------------------------------------------------------- model replicas


def _flat_state(module: torch.nn.Module) -> Dict[torch.dtype, list]:
    groups: Dict[torch.dtype, list] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        groups.setdefault(t.dtype, []).append(t)
    return groups


def broadcast_module(module: torch.nn.Module, mesh: Optional[DataMesh],
                     src: int = 0) -> torch.nn.Module:
    """Rank ``src``'s parameters and buffers into every rank's ``module``,
    one broadcast per dtype. Without a group: a no-op."""
    if not is_distributed(mesh):
        return module
    with torch.no_grad():
        for tensors in _flat_state(module).values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            COLLECTIVES["broadcast"] += 1
            dist.broadcast(flat, src=src, group=mesh.group)
            i = 0
            for t in tensors:
                t.copy_(flat[i:i + t.numel()].view(t.shape))
                i += t.numel()
    return module


def assert_replicated(module: torch.nn.Module,
                      mesh: Optional[DataMesh]) -> bool:
    """Raise on every rank unless every rank's parameters and buffers are
    bit-equal to rank 0's. Without a group: True."""
    if not is_distributed(mesh):
        return True
    bad = 0
    with torch.no_grad():
        for tensors in _flat_state(module).values():
            mine = torch.cat([t.reshape(-1) for t in tensors])
            ref = mine.clone()
            COLLECTIVES["broadcast"] += 1
            dist.broadcast(ref, src=0, group=mesh.group)
            bad += int(not torch.equal(mine.view(torch.uint8),
                                       ref.view(torch.uint8)))
    flag = torch.tensor([float(bad)], device=mesh.device)
    _all_reduce(flag, mesh)
    if flag.item():
        raise RuntimeError(f"the model's replicas differ on "
                           f"{int(flag.item())} (rank, dtype) groups")
    return True
