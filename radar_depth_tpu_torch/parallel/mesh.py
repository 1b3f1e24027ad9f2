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

``make_spatial_mesh`` lays the ranks out as (data, space), JAX's
``make_spatial_mesh``: the batch splits over ``data`` only, and the ranks of
one space group hold the same samples, each a slab of the image rows
(``parallel/spatial.py``). Reductions over the batch still span the world,
since the slabs partition the pixels.
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
    ``axis_names`` and ``shape`` describe the layout (``("data",)``,
    ``("replica", "data")`` or ``("data", "space")``). The batch splits
    over every axis but ``space``, and every reduction over the batch spans
    the whole world, so a layout without ``space`` does not change the
    numbers. With ``space_size`` S > 1, rank r sits at (r // S, r % S):
    ``space_group`` holds the S ranks of its data index, which share its
    samples, and ``data_group`` the ranks of its space index."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    axis_names: Tuple[str, ...] = ("data",)
    shape: Tuple[int, ...] = (1,)
    backend: Optional[str] = None
    created: bool = False  # make_mesh initialised the default group
    space_size: int = 1
    space_group: Any = None
    data_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_size(self) -> int:
        return self.world // self.space_size

    @property
    def data_index(self) -> int:
        return self.rank // self.space_size

    @property
    def space_index(self) -> int:
        return self.rank % self.space_size

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
    (``torch.cuda.set_device`` first; a ``LOCAL_RANK`` past the visible
    cards raises) or over gloo on the CPU, initialised
    from the environment unless it exists already; a world of 1 makes a
    group too, so its collectives run.

    ``backend`` overrides NCCL on the card, for two ranks on one card over
    gloo (a check: NCCL refuses it); nothing falls back to it."""
    env = os.environ
    distributed = dist.is_initialized() or (
        "RANK" in env and "WORLD_SIZE" in env)
    local = int(env.get("LOCAL_RANK", 0))
    dev = resolve_device("cpu" if platform == "cpu" else None)
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
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {env.get('RANK')} (LOCAL_RANK {local}) has no card "
                f"of its own: {dev} of {torch.cuda.device_count()} visible; "
                "start one rank per card")
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


def make_spatial_mesh(spatial: int, platform: str = "default",
                      **kw) -> DataMesh:
    """The (data, space) layout of the world (JAX's ``make_spatial_mesh``):
    shape (world // spatial, spatial), rank r at (r // spatial, r %
    spatial). Image height is sharded over ``space``
    (``parallel/spatial.py``), the batch over ``data``. Every rank makes
    every subgroup, in the same order: the space groups, then the data
    groups. ``kw`` goes to ``make_mesh``."""
    mesh = make_mesh(platform, **kw)
    if spatial < 1 or mesh.world % spatial:
        destroy_mesh(mesh)
        raise ValueError(
            f"spatial={spatial} must divide the world size {mesh.world} "
            f"(run under torchrun with a multiple of {spatial} ranks)")
    data = mesh.world // spatial
    space_groups = [dist.new_group([d * spatial + s for s in range(spatial)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * spatial + s for d in range(data)])
                   for s in range(spatial)]
    return dataclasses.replace(
        mesh, axis_names=("data", "space"), shape=(data, spatial),
        space_size=spatial, space_group=space_groups[mesh.rank // spatial],
        data_group=data_groups[mesh.rank % spatial])


def destroy_mesh(mesh: Optional[DataMesh]) -> None:
    """Destroy the default process group if ``make_mesh`` made it."""
    if mesh is not None and mesh.created and dist.is_initialized():
        dist.destroy_process_group()


def check_batch_sizes(mesh: DataMesh, **sizes: int) -> None:
    """The JAX Trainer's check: each global batch size (0 = unset) must
    split evenly over the data axis."""
    n = mesh.data_size
    for name, bs in sizes.items():
        if bs and bs % n != 0:
            raise ValueError(
                f"{name}={bs} is not divisible by the {n}-rank "
                f"data mesh — pick a multiple of {n} (each rank "
                "takes an equal share of the batch)")


# -------------------------------------------------------------- batches


def local_rows(batch, mesh: Optional[DataMesh], accum: bool = False):
    """This rank's rows of a global batch: rows ``[d*b, (d+1)*b)`` of dim 0
    (dim 1 with ``accum``: leaves stacked (grad_accum, batch, ...)), d the
    rank's data index and b the global rows over the data axis's size (the
    ranks of a space group take the same rows); the counterpart of
    ``shard_batch(process_local=True)``. ``batch`` is a dict, list or tuple
    of arrays or tensors, or one of them (None stays None). A data axis of
    1 returns ``batch``."""
    if mesh is None or mesh.data_size == 1 or batch is None:
        return batch
    if isinstance(batch, dict):
        return {k: local_rows(v, mesh, accum) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_rows(v, mesh, accum) for v in batch)
    dim = 1 if accum else 0
    n = batch.shape[dim]
    if n % mesh.data_size:
        raise ValueError(f"{n} rows do not split over {mesh.data_size} ranks")
    b = n // mesh.data_size
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
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


def _all_reduce(t: torch.Tensor, mesh: DataMesh, group: Any = None,
                kind: str = "all_reduce") -> torch.Tensor:
    """SUM all-reduce of ``t`` in place over ``group`` (default: the
    world), counted under ``kind``."""
    COLLECTIVES[kind] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM,
                    group=mesh.group if group is None else group)
    return t


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh],
                   dtype: Optional[torch.dtype] = None,
                   group: Any = None) -> List[torch.Tensor]:
    """The sums over ranks of ``tensors`` (no gradient), through one buffer
    in ``dtype`` (default: the first tensor's) and one collective over
    ``group`` (default: the world); each comes back in its own shape and
    dtype. Without a group: ``tensors``."""
    if not is_distributed(mesh):
        return list(tensors)
    dtype = dtype or tensors[0].dtype
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    _all_reduce(flat, mesh, group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def gather_batch(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The global batch (dim 0) on every rank of a data group, from each
    data rank's ``local_rows``: one all-reduce of a zero-filled buffer over
    ``mesh.data_group`` (no gradient). ``x`` itself on a data axis of 1."""
    if not is_distributed(mesh) or mesh.data_size == 1:
        return x
    n = x.shape[0]
    full = x.new_zeros((n * mesh.data_size,) + tuple(x.shape[1:]))
    full[mesh.data_index * n:(mesh.data_index + 1) * n] = x.detach()
    return _all_reduce(full, mesh, mesh.data_group or mesh.group)


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

    Forward, with w_r this rank's share of the global element count
    (1/world when every rank holds as many): m = sum_q w_q mean_q, then
    v = sum_q w_q (var_q + (mean_q - m)^2). Backward, G_m and G_v the sums
    over ranks of the upstream gradients of m and v (one all-reduce of the
    pair): dvar_r = w_r G_v and dmean_r = w_r (G_m + 2 (mean_r - m) G_v).
    The path of m through v is left out: its gradient is
    -2 G_v sum_q w_q (mean_q - m), which is 0."""

    @staticmethod
    def forward(ctx, mean, var, mesh, w):
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
        return d_mean, g_var * ctx.w, None, None


def global_moments(mean: torch.Tensor, var: torch.Tensor, mesh: DataMesh,
                   share: Optional[float] = None):
    """Global-batch (mean, biased variance) from each rank's own: the
    ranks' means weighted by ``share``, this rank's fraction of the global
    element count (default 1/world: every rank holds as many rows, as
    ``local_rows`` splits them; a row slab of ``parallel/spatial.py`` may
    hold fewer), then the weighted mean of ``var_r + (mean_r - mean)^2``,
    which is sum (x - mean)^2 / N over the global batch; differentiable,
    through three all-reduces (two forward, one backward). Each rank's
    moments come from its own ``kernels.bn_train_moments`` (kernel D's
    statistics pass on the card, Welford's and Chan's formulas; the
    two-pass ``var_mean`` on the CPU), so the variance keeps the digits of
    a two-pass one, and at world 1 the result and its gradients have the
    bits of the rank's own moments. A share computed as
    n_r / N is 1/world to the bit when the counts are equal."""
    return _GlobalMoments.apply(mean, var, mesh,
                                1.0 / mesh.world if share is None else share)


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
