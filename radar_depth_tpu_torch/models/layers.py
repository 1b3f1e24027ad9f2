"""Low-level layers of the port, NCHW tensors in channels_last memory (NHWC
bytes, as the JAX package and kernel B use).

Mirrors ``radar_depth_tpu/models/layers.py``. Convolutions go to cuDNN
through ``torch.nn.functional``. Modules follow ``train()`` / ``eval()``: in
eval mode every BN that is followed by a ReLU runs as kernel B
(``ops/kernels.py::batch_norm_relu``, the BN folded inside the kernel), with
its optional residual; in train mode BN normalizes with batch statistics
through kernel D (``ops/kernels.py::bn_train_moments``, ``bn_train_apply``:
statistics, apply with its residual and ReLU, and their backward), where
flax's ``BatchNorm`` is plain XLA in the JAX package.

Parameter names follow the flax tree: a conv's ``kernel`` is ``weight``
(OIHW), a BN's ``scale``/``bias`` are ``weight``/``bias`` and its
``batch_stats`` ``mean``/``var`` are ``running_mean``/``running_var``.
Convs hold their weight in ``param_dtype`` and compute in ``dtype``, as
flax's modules do: training keeps float32 weights and casts them per call.

Spatial partitioning (``parallel/spatial.py``): with a mesh whose space axis
has more than one rank (``use_mesh``), every op with an extent along H (the
convs, the transposed convs, the max pool, the resize) takes this rank's
slab of rows and returns its slab of the output rows, computed from
``gather_rows`` of the input rows they read, with no padding in H. Each op
must know the global height of its input: ``plan_rows(h)`` records it and
returns the output's, and the models call it down their forward order
(``use_mesh`` starts it at the model's full height). BN needs the global
height too, to weight its rank's moments.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.parallel.mesh import global_moments, is_distributed
from radar_depth_tpu_torch.parallel.spatial import (
    check_rows,
    gather_rows,
    is_spatial,
    owned_rows,
    windows_of,
)


def _param(shape, dtype, device, channels_last=False) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t)


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory, in ``dtype``."""
    return x.permute(0, 3, 1, 2).to(dtype)


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    """A convolution's output in channels_last memory. cuDNN returns it so
    already (a no-op in eager mode); said explicitly because a tracer's fake
    convolution may infer contiguous memory where the card does not (the
    one-channel radar stem under torch 2.11's ``torch.export``), and kernel
    B's wrapper checks the layout of what the tracer gives it."""
    return y.contiguous(memory_format=torch.channels_last)


class _RowsAlongH:
    """What an op along H needs in spatial mode: ``mesh`` (set by
    ``use_mesh``) and the global heights of its input and output (set by
    ``plan_rows``)."""

    mesh = None
    rows_in = rows_out = None

    def out_rows(self, h: int) -> int:
        raise NotImplementedError

    def plan_rows(self, h: int) -> int:
        self.rows_in, self.rows_out = h, self.out_rows(h)
        check_rows(self.rows_out, self.mesh, type(self).__name__)
        return self.rows_out

    def gather(self, x: torch.Tensor, need, pad: float = 0.0):
        """The input rows this rank's output rows read: ``need(a, b)`` ->
        (lo, hi) for output rows [a, b)."""
        return gather_rows(x, self.mesh, self.rows_in,
                           windows_of(self.rows_out, self.mesh.space_size,
                                      need), pad)


class Conv2d(_RowsAlongH, nn.Module):
    """Bias-free conv with torch-style symmetric padding, computed in
    ``dtype``. The weight is held in ``param_dtype`` (default: ``dtype``, so
    serving casts a float32 state_dict once at load); with float32 weights
    and a bfloat16 ``dtype`` it is cast per call, as the JAX package casts
    its kernel."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dtype = dtype
        self.weight = _param((cout, cin, kernel_size, kernel_size),
                             param_dtype or dtype, device, channels_last=True)

    def out_rows(self, h: int) -> int:
        k = self.weight.shape[2]
        return (h + 2 * self.padding - k) // self.stride + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if not is_spatial(self.mesh):
            return _channels_last(F.conv2d(x, w, stride=self.stride,
                                           padding=self.padding))
        k, s, p = w.shape[2], self.stride, self.padding
        x = self.gather(x, lambda a, b: (a * s - p, (b - 1) * s - p + k))
        return _channels_last(F.conv2d(x, w, stride=s, padding=(0, p)))


class HeadConv3(Conv2d):
    """Final 3x3 conv -> 1 channel (flax ``HeadConv3``, param ``kernel``)."""

    def __init__(self, cin: int, dtype=torch.float32, param_dtype=None,
                 device=None):
        super().__init__(cin, 1, 3, 1, 1, dtype=dtype, param_dtype=param_dtype,
                         device=device)


class UnpoolConv(Conv2d):
    """Zero-insertion stride-2 unpool followed by a KxK conv with padding
    K//2, computed as one transposed conv (the zeros never exist): with the
    kernel flipped and its in/out axes swapped, ``conv_transpose2d(stride 2,
    padding K//2, output_padding 1)`` is exactly ``conv(unpool(x))``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__(cin, cout, kernel_size, 1, kernel_size // 2,
                         dtype=dtype, param_dtype=param_dtype, device=device)

    def out_rows(self, h: int) -> int:
        return 2 * h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        w = self.weight.to(self.dtype).flip((2, 3)).transpose(0, 1)
        return _transposed(self, x.to(self.dtype), w, 2, k // 2,
                           2 * (k // 2) + 2 - k)


class ConvTranspose(Conv2d):
    """Bias-free torch ``ConvTranspose2d`` (flax ``TorchConvTranspose``), the
    up-sampling conv of the DeConv blocks. The JAX module flips its (k,k,I,O)
    kernel and convolves the stride-dilated input; the converted weight is
    (O,I,k,k), and torch's ``conv_transpose2d`` takes (I,O,k,k) unflipped, so
    the forward swaps the two axes and flips nothing."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 2,
                 padding: int = 0, output_padding: int = 0,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__(cin, cout, kernel_size, stride, padding, dtype=dtype,
                         param_dtype=param_dtype, device=device)
        self.output_padding = output_padding

    def out_rows(self, h: int) -> int:
        k = self.weight.shape[2]
        return ((h - 1) * self.stride - 2 * self.padding + k
                + self.output_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype).transpose(0, 1)
        return _transposed(self, x.to(self.dtype), w, self.stride,
                           self.padding, self.output_padding)


def _transposed(op: Conv2d, x, w, s: int, p: int, out_pad: int):
    """``conv_transpose2d(x, w, s, p, out_pad)``, or in spatial mode this
    rank's output rows [a, b): input row i reaches output rows i*s - p +
    [0, k), so they read input rows [ceil((a+p-k+1)/s), floor((b-1+p)/s)]
    (zeros beyond the edges add nothing); the transposed conv of those rows
    without padding in H starts at output row lo*s - p."""
    if not is_spatial(op.mesh):
        return _channels_last(F.conv_transpose2d(
            x, w, stride=s, padding=p, output_padding=out_pad))
    k = w.shape[2]

    def need(a, b):
        return -((k - 1 - a - p) // s), (b - 1 + p) // s + 1

    a, b = owned_rows(op.rows_out, op.mesh)
    start = a - (need(a, b)[0] * s - p)
    y = F.conv_transpose2d(op.gather(x, need), w, stride=s, padding=(0, p),
                           output_padding=(0, out_pad))
    return _channels_last(y[:, :, start:start + b - a])


class BatchNorm(nn.Module):
    """BatchNorm with flax semantics; the output is in x's dtype.

    Eval mode: the folded ``scale = gamma/sqrt(var+eps)`` and ``bias = beta -
    mean*scale`` are float32; ``forward(x, relu=True, residual=r)`` is
    ``relu(bn(x) + r)`` through kernel B, which folds the BN's parameters and
    running statistics itself (one launch), and without ``relu`` the BN is
    plain PyTorch. ``plain=True`` sends kernel B's and kernel D's sites to
    their plain versions (kernel B's: ``folded()``, then
    ``scale_bias_relu_reference``) on any device (the reference on the card,
    set by ``use_plain_kernels``).

    Train mode: flax's ``BatchNorm`` through kernel D (``ops/kernels.py::
    bn_train_moments`` then ``bn_train_apply``, two autograd nodes; their
    plain versions on the CPU). Batch statistics in (at least) float32 over
    (N, H, W), the variance biased, both for normalizing and for the running
    update ``running = momentum*running + (1-momentum)*batch`` (torch's own
    ``F.batch_norm`` would store the unbiased variance), done by the apply.
    The variance is not flax's one-pass E[x^2] - E[x]^2, which loses digits
    in float32 where a channel's mean dwarfs its spread: the plain version
    takes two passes, the kernel Welford's and Chan's formulas. With a data
    mesh that has a process group (``use_mesh``) the statistics are those of
    the global batch (``parallel/mesh.py::global_moments``), as the JAX step
    computes them over its one graph, each rank's moments weighted by its
    share of the elements (row slabs of a spatial mesh differ by a row);
    eval mode is unchanged.
    """

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 momentum: float = 0.9, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.plain = False
        # False while a checkpointed stage is recomputed in the backward
        # (``frozen_running_stats``): flax's remat moves the statistics once
        self.update_stats = True
        self.mesh = None  # parallel.mesh.DataMesh of the train-mode stats
        self.rows_in = None  # global height of the input (spatial mode)
        self.weight = _param((channels,), torch.float32, device)
        self.bias = _param((channels,), torch.float32, device)
        self.register_buffer("running_mean", torch.empty(
            channels, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.empty(
            channels, dtype=torch.float32, device=device))

    def plan_rows(self, h: int) -> int:
        self.rows_in = h
        return h

    def _share(self, x) -> float | None:
        """This rank's fraction of the global element count per channel,
        when its rows are a slab of the global height (spatial mode); else
        None, every rank holding as many."""
        if not is_spatial(self.mesh):
            return None
        n, _, h, w = x.shape
        return (n * h * w) / (n * self.rows_in * w * self.mesh.data_size)

    def folded(self):
        return kernels.fold_batch_norm(self.weight, self.bias,
                                       self.running_mean, self.running_var,
                                       self.epsilon)

    def _train_forward(self, x, relu, residual):
        link = kernels.BnTrainLink()
        mean, var = kernels.bn_train_moments(x, self.plain, link)
        if is_distributed(self.mesh):
            mean, var = global_moments(mean, var, self.mesh,
                                       self._share(x))
        running = ((self.running_mean, self.running_var, self.momentum)
                   if self.update_stats else None)
        return kernels.bn_train_apply(x, mean, var, self.weight, self.bias,
                                      self.epsilon, residual, relu, running,
                                      self.plain, link)

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if residual is not None and not relu:
            raise ValueError("a residual is added only before a ReLU")
        if self.training:
            return self._train_forward(x, relu, residual)
        if relu and not self.plain:
            return kernels.batch_norm_relu(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.epsilon, residual)
        scale, bias = self.folded()
        if relu:
            return kernels.scale_bias_relu_reference(x, scale, bias, residual)
        y = x.float() * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def make_norm(channels: int, device=None) -> BatchNorm:
    """The model's BatchNorm: torch ``BatchNorm2d(momentum=0.1, eps=1e-5)``,
    which is flax's retain factor 0.9 (the flax ``make_norm``)."""
    return BatchNorm(channels, epsilon=1e-5, momentum=0.9, device=device)


def use_plain_kernels(model: nn.Module, plain: bool = True) -> nn.Module:
    """Route every kernel-B and kernel-D site of ``model`` (its BatchNorms)
    to the plain versions."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.plain = plain
    return model


def use_mesh(model: nn.Module, mesh) -> nn.Module:
    """Point every module of ``model`` that has a ``mesh`` attribute at
    ``mesh`` (None: the rank's own batch): train-mode BN normalizes with
    the statistics of ``mesh``'s global batch, and with a space axis the
    ops along H run on row slabs, their heights planned from the model's
    full height (``model.plan_rows()``)."""
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    if is_spatial(mesh):
        model.plan_rows()
    return model


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Context: the train-mode BNs of ``model`` normalize with batch
    statistics as always but leave their running statistics alone (the
    recompute of a checkpointed stage)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


def pool_rows(h: int, window: int = 3, stride: int = 2,
              padding: int = 1) -> int:
    return (h + 2 * padding - window) // stride + 1


def max_pool_torch(x: torch.Tensor, window: int = 3, stride: int = 2,
                   padding: int = 1, mesh=None,
                   rows: int | None = None) -> torch.Tensor:
    """MaxPool2d(window, stride, padding), floor mode, -inf padding. With a
    spatial ``mesh``, ``x`` is this rank's slab of ``rows`` global rows and
    the result its slab of the output rows."""
    if not is_spatial(mesh):
        return F.max_pool2d(x, window, stride, padding)
    windows = windows_of(
        pool_rows(rows, window, stride, padding), mesh.space_size,
        lambda a, b: (a * stride - padding,
                      (b - 1) * stride - padding + window))
    x = gather_rows(x, mesh, rows, windows, float("-inf"))
    return F.max_pool2d(x, window, stride, (0, padding))


_INTERP: dict = {}


def _interp_matrix(out_size: int, in_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Row-stochastic (out, in) bilinear interpolation matrix, half-pixel
    centers with edge clamping (the JAX package's ``_interp_matrix``), built
    once per shape, dtype and device. Under a tracer (``torch.export``) the
    tensor built is the tracer's fake one, which is not kept: the next eager
    call would get it."""
    key = (out_size, in_size, dtype, device)
    if key in _INTERP:
        return _INTERP[key]
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(int)
    frac = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), np.clip(lo, 0, in_size - 1)), 1.0 - frac)
    np.add.at(m, (np.arange(out_size), np.clip(lo + 1, 0, in_size - 1)), frac)
    with torch.inference_mode(False):  # cached: must serve autograd too
        t = torch.from_numpy(m).to(device=device, dtype=dtype)
    if type(t) is torch.Tensor:
        _INTERP[key] = t
    return t


def _interp_window(out_size: int, in_size: int, a: int, b: int):
    """[lo, hi) of the input rows that output rows [a, b) of
    ``_interp_matrix(out_size, in_size)`` weight."""
    scale = in_size / out_size

    def src(o):
        return int(np.floor((o + 0.5) * scale - 0.5))

    return (min(max(src(a), 0), in_size - 1),
            min(max(src(b - 1) + 1, 0), in_size - 1) + 1)


def resize_bilinear(x: torch.Tensor, height: int, width: int, mesh=None,
                    rows: int | None = None) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and edge clamping
    (align_corners=False), in x's dtype, as two separable matmuls y = R_h x
    R_w^T: the JAX ``resize_bilinear_matmul``. Its backward is two matmuls
    as well, so a train step is deterministic on the card, where
    ``F.interpolate``'s backward adds with atomics. With a spatial
    ``mesh``, ``x`` is this rank's slab of ``rows`` global rows, and its
    output rows [a, b) of ``height`` are R_h[a:b] applied to the input rows
    they weight."""
    rw = _interp_matrix(width, x.shape[3], x.dtype, x.device)
    if not is_spatial(mesh):
        rh = _interp_matrix(height, x.shape[2], x.dtype, x.device)
        return torch.matmul(torch.matmul(rh, x), rw.t())
    windows = windows_of(height, mesh.space_size,
                         lambda a, b: _interp_window(height, rows, a, b))
    a, b = owned_rows(height, mesh)
    lo, hi = windows[mesh.space_index]
    rh = _interp_matrix(height, rows, x.dtype, x.device)[a:b, lo:hi]
    x = gather_rows(x, mesh, rows, windows)
    return torch.matmul(torch.matmul(rh, x), rw.t())
