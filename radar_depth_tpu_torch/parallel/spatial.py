"""Spatial partitioning of the port (``--spatial``): image height sharded
over the ``space`` axis of a (data, space) mesh
(``parallel/mesh.py::make_spatial_mesh``).

In the JAX package ``--spatial`` is one sharding constraint and GSPMD
writes the halo exchanges. Here a rank of a space group holds a slab of the
rows of every (N, C, H, W) activation, and each op with an extent along H
(``models/layers.py``: convs, transposed convs, the max pool, the resize)
computes exactly its own output rows from ``gather_rows`` of the input rows
they need.

Rows. Of H global rows, space rank s of S owns the contiguous rows
``row_range(H, s, S)``: H // S each, the first H % S ranks one more. The
rule is defined for every H (the flagship's 450 -> 225 -> 113 -> 57 -> 29
-> 15 rows split unevenly), and the same rule partitions each tensor's own
height: an op's output partition is that of its output height, whatever the
input's was.

Halo exchange. Every rank knows every rank's window (it follows from the
heights and the op), so one SUM all-reduce over the space group carries all
halos at once: a zero-filled buffer holds, rank by rank, the rows each rank
needs and does not own, and each rank writes only the rows it owns. A row
comes from exactly one rank, so the sum is the row. Its backward is the same
all-reduce of the gradients of those rows, each rank then adding into its
slab the gradients of the rows it owns, from every window that holds them
(a row can sit in the windows of several ranks when slabs are thinner than
the halo). Only ``all_reduce`` is used, which gloo carries for CUDA tensors
as well as NCCL. Exchanges count in ``parallel.mesh.COLLECTIVES`` under
``halo`` (forward) and ``halo_grad`` (backward); ``HALO`` adds their bytes
and host seconds.

Inside a CUDA graph (``graphs.py``, over an NCCL mesh) the exchanges are
captured with the step or forward, and this Python runs only at the
capture: a replay adds the capture's exchanges and bytes to ``COLLECTIVES``
and ``HALO["bytes"]``, so a replay counts what an eager call counts, and
adds no host seconds, which are those of eager calls alone (a replay's
exchange time is read from device events, as a trace shows it).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from radar_depth_tpu_torch.parallel.mesh import (
    DataMesh,
    _all_reduce,
    is_distributed,
)

# bytes moved and host seconds spent by the halo exchanges since the last
# reset, in this process (keys "bytes", "seconds")
HALO: collections.Counter = collections.Counter()


def is_spatial(mesh: Optional[DataMesh]) -> bool:
    """True when ``mesh`` shards image height over more than one rank."""
    return is_distributed(mesh) and mesh.space_size > 1


def row_range(height: int, index: int, size: int) -> Tuple[int, int]:
    """[lo, hi) of the rows of ``height`` that space rank ``index`` of
    ``size`` owns."""
    base, extra = divmod(height, size)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def owned_rows(height: int, mesh: DataMesh) -> Tuple[int, int]:
    return row_range(height, mesh.space_index, mesh.space_size)


def check_rows(height: int, mesh: DataMesh, what: str = "a tensor") -> None:
    """Raise unless every space rank owns at least one of ``height``
    rows."""
    if height < mesh.space_size:
        raise ValueError(
            f"{what} has {height} rows, fewer than the {mesh.space_size} "
            "ranks of the space axis: --spatial needs a taller image")


def slab(x: torch.Tensor, mesh: Optional[DataMesh], dim: int = 2):
    """This rank's rows (dim ``dim``) of the full-height tensor ``x``; ``x``
    itself without a space axis."""
    if not is_spatial(mesh):
        return x
    lo, hi = owned_rows(x.shape[dim], mesh)
    return x.narrow(dim, lo, hi - lo)


def spatial_constraint(prepared: Dict, mesh: Optional[DataMesh]) -> Dict:
    """This rank's slab of every NHWC leaf (4-d tensor) of a prepared batch,
    the other leaves as they are: JAX's ``spatial_constraint``. The prepared
    batch itself without a space axis."""
    if not is_spatial(mesh):
        return prepared
    return {k: slab(v, mesh, 1) if getattr(v, "dim", lambda: 0)() == 4
            else v for k, v in prepared.items()}


def unslab(x: torch.Tensor, mesh: Optional[DataMesh], height: int,
           dim: int = 2) -> torch.Tensor:
    """The full-height tensor (``height`` rows along ``dim``) on every rank
    of the space group, from each rank's slab: one all-reduce of a
    zero-filled buffer (no gradient). ``x`` itself without a space axis."""
    if not is_spatial(mesh):
        return x
    lo, hi = owned_rows(height, mesh)
    if x.shape[dim] != hi - lo:
        raise ValueError(f"a slab of {x.shape[dim]} rows is not rank "
                         f"{mesh.space_index}'s {hi - lo} of {height}")
    shape = list(x.shape)
    shape[dim] = height
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, lo, hi - lo).copy_(x.detach())
    return _all_reduce(full, mesh, mesh.space_group)


# ---------------------------------------------------------------- halos


def _remote(lo: int, hi: int, own: Tuple[int, int], height: int):
    """The rows of window [lo, hi) inside [0, height) that ``own`` does not
    hold, as at most two intervals (above it, below it)."""
    lo, hi = max(lo, 0), min(hi, height)
    out = []
    if lo < min(hi, own[0]):
        out.append((lo, min(hi, own[0])))
    if max(lo, own[1]) < hi:
        out.append((max(lo, own[1]), hi))
    return out


class _Plan:
    """Where each rank's remote rows sit in the exchange buffer:
    ``segments`` is [(rank, u, v, offset)] for global rows [u, v)."""

    def __init__(self, height: int, windows: Sequence[Tuple[int, int]]):
        size = len(windows)
        self.owned = [row_range(height, q, size) for q in range(size)]
        self.segments, off = [], 0
        for q, (lo, hi) in enumerate(windows):
            for u, v in _remote(lo, hi, self.owned[q], height):
                self.segments.append((q, u, v, off))
                off += v - u
        self.rows = off

    def mine(self, q: int):
        """(u, v, offset) of the segments whose rows rank ``q`` owns, cut
        to those rows."""
        a, b = self.owned[q]
        for _, u, v, off in self.segments:
            u2, v2 = max(u, a), min(v, b)
            if u2 < v2:
                yield u2, v2, off + u2 - u


def _exchange(buf: torch.Tensor, mesh: DataMesh, kind: str) -> torch.Tensor:
    t0 = time.perf_counter()
    _all_reduce(buf, mesh, mesh.space_group, kind)
    HALO["bytes"] += buf.numel() * buf.element_size()
    HALO["seconds"] += time.perf_counter() - t0
    return buf


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` in one autograd node (module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh, height, windows, pad, plan):
        me = mesh.space_index
        a, b = plan.owned[me]
        n, c, _, w = x.shape
        buf = None
        if plan.rows:
            buf = x.new_zeros((n, c, plan.rows, w))
            for u, v, off in plan.mine(me):
                buf[:, :, off:off + v - u] = x[:, :, u - a:v - a]
            _exchange(buf, mesh, "halo")
        lo, hi = windows[me]
        parts = []
        if lo < 0:
            parts.append(x.new_full((n, c, -lo, w), pad))
        pieces = [(u, v, buf[:, :, off:off + v - u])
                  for q, u, v, off in plan.segments if q == me]
        if max(lo, a) < min(hi, b):
            pieces.append((max(lo, a), min(hi, b),
                           x[:, :, max(lo, a) - a:min(hi, b) - a]))
        parts += [t for _, _, t in sorted(pieces, key=lambda p: p[0])]
        if hi > height:
            parts.append(x.new_full((n, c, hi - height, w), pad))
        ctx.mesh, ctx.plan, ctx.window = mesh, plan, (lo, hi)
        ctx.shape = x.shape
        out = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0].clone()
        # the model's layout (models/layers.py): NHWC bytes
        return out.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        mesh, plan, (lo, hi) = ctx.mesh, ctx.plan, ctx.window
        me = mesh.space_index
        a, b = plan.owned[me]
        n, c, _, w = ctx.shape
        grad = g.new_zeros(ctx.shape)
        u, v = max(lo, a), min(hi, b)
        if u < v:
            grad[:, :, u - a:v - a] += g[:, :, u - lo:v - lo]
        if plan.rows:
            buf = g.new_zeros((n, c, plan.rows, w))
            for q, u, v, off in plan.segments:
                if q == me:
                    buf[:, :, off:off + v - u] = g[:, :, u - lo:v - lo]
            _exchange(buf, mesh, "halo_grad")
            for u, v, off in plan.mine(me):
                grad[:, :, u - a:v - a] += buf[:, :, off:off + v - u]
        return grad, None, None, None, None, None


def gather_rows(x: torch.Tensor, mesh: DataMesh, height: int,
                windows: Sequence[Tuple[int, int]],
                pad: float = 0.0) -> torch.Tensor:
    """Rows [lo, hi) = ``windows[mesh.space_index]`` of the global
    (N, C, ``height``, W) tensor whose slab this rank holds in ``x``: its
    own rows, the others' from one exchange over the space group, and
    ``pad`` (0, or -inf for a max pool) beyond the global edges.
    ``windows`` holds every space rank's window, the same on every rank.
    Differentiable: the backward sums each row's gradient back onto its
    owner. Without remote rows in any window, no collective runs."""
    if len(windows) != mesh.space_size:
        raise ValueError(f"{len(windows)} windows for {mesh.space_size} "
                         "space ranks")
    plan = _Plan(height, windows)
    own = plan.owned[mesh.space_index]
    if x.shape[2] != own[1] - own[0]:
        raise ValueError(f"a slab of {x.shape[2]} rows is not rank "
                         f"{mesh.space_index}'s {own[1] - own[0]} of "
                         f"{height}")
    if not plan.rows and tuple(windows[mesh.space_index]) == own:
        return x
    return _GatherRows.apply(x, mesh, height, list(windows), pad, plan)


def windows_of(out_height: int, size: int, need) -> List[Tuple[int, int]]:
    """Every space rank's input window: ``need(a, b)`` -> (lo, hi) of the
    input rows that output rows [a, b) read, for each rank's own output
    rows."""
    return [need(*row_range(out_height, q, size)) for q in range(size)]
