"""Low-level layers of the port, NCHW tensors in channels_last memory (NHWC
bytes, as the JAX package and kernel B use).

Mirrors ``radar_depth_tpu/models/layers.py``. Convolutions go to cuDNN
through ``torch.nn.functional``. Modules follow ``train()`` / ``eval()``: in
eval mode every BN that is followed by a ReLU runs as kernel B
(``ops/kernels.py::scale_bias_relu``), with its optional residual; in train
mode BN normalizes with batch statistics in plain PyTorch with autograd, as
flax's ``BatchNorm`` does in plain XLA in the JAX package.

Parameter names follow the flax tree: a conv's ``kernel`` is ``weight``
(OIHW), a BN's ``scale``/``bias`` are ``weight``/``bias`` and its
``batch_stats`` ``mean``/``var`` are ``running_mean``/``running_var``.
Convs hold their weight in ``param_dtype`` and compute in ``dtype``, as
flax's modules do: training keeps float32 weights and casts them per call.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from radar_depth_tpu_torch.ops import kernels


def _param(shape, dtype, device, channels_last=False) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t)


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory, in ``dtype``."""
    return x.permute(0, 3, 1, 2).to(dtype)


class Conv2d(nn.Module):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        w = self.weight.to(self.dtype).flip((2, 3)).transpose(0, 1)
        return F.conv_transpose2d(x.to(self.dtype), w, stride=2,
                                  padding=k // 2,
                                  output_padding=2 * (k // 2) + 2 - k)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype).transpose(0, 1)
        return F.conv_transpose2d(x.to(self.dtype), w, stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class BatchNorm(nn.Module):
    """BatchNorm with flax semantics; the output is in x's dtype.

    Eval mode: the folded ``scale = gamma/sqrt(var+eps)`` and ``bias = beta -
    mean*scale`` are float32; ``forward(x, relu=True, residual=r)`` is
    ``relu(bn(x) + r)`` through kernel B, and without ``relu`` the BN is plain
    PyTorch. ``plain=True`` sends kernel B's sites to its plain version on any
    device (the reference on the card, set by ``use_plain_kernels``).

    Train mode: flax's ``BatchNorm`` in plain PyTorch with autograd. Batch
    statistics in (at least) float32 over (N, H, W), the variance biased,
    both for normalizing and for the running update ``running =
    momentum*running + (1-momentum)*batch`` (torch's own ``F.batch_norm``
    would store the unbiased variance). The variance is taken in two passes:
    flax's one-pass E[x^2] - E[x]^2 is the same quantity but loses digits in
    float32 where a channel's mean dwarfs its spread.
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
        self.weight = _param((channels,), torch.float32, device)
        self.bias = _param((channels,), torch.float32, device)
        self.register_buffer("running_mean", torch.empty(
            channels, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.empty(
            channels, dtype=torch.float32, device=device))

    def folded(self):
        scale = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        return scale, self.bias - self.running_mean * scale

    def _train_forward(self, x, relu, residual):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = ((xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
             + self.bias.view(1, -1, 1, 1)).to(x.dtype)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if residual is not None and not relu:
            raise ValueError("a residual is added only before a ReLU")
        if self.training:
            return self._train_forward(x, relu, residual)
        scale, bias = self.folded()
        if relu:
            fn = (kernels.scale_bias_relu_reference if self.plain
                  else kernels.scale_bias_relu)
            return fn(x, scale, bias, residual)
        y = x.float() * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def make_norm(channels: int, device=None) -> BatchNorm:
    """The model's BatchNorm: torch ``BatchNorm2d(momentum=0.1, eps=1e-5)``,
    which is flax's retain factor 0.9 (the flax ``make_norm``)."""
    return BatchNorm(channels, epsilon=1e-5, momentum=0.9, device=device)


def use_plain_kernels(model: nn.Module, plain: bool = True) -> nn.Module:
    """Route every kernel-B site of ``model`` to the plain version."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.plain = plain
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


def max_pool_torch(x: torch.Tensor, window: int = 3, stride: int = 2,
                   padding: int = 1) -> torch.Tensor:
    """MaxPool2d(window, stride, padding), floor mode, -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


@functools.lru_cache(maxsize=None)
def _interp_matrix(out_size: int, in_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Row-stochastic (out, in) bilinear interpolation matrix, half-pixel
    centers with edge clamping (the JAX package's ``_interp_matrix``), built
    once per shape, dtype and device."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(int)
    frac = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), np.clip(lo, 0, in_size - 1)), 1.0 - frac)
    np.add.at(m, (np.arange(out_size), np.clip(lo + 1, 0, in_size - 1)), frac)
    with torch.inference_mode(False):  # cached: must serve autograd too
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and edge clamping
    (align_corners=False), in x's dtype, as two separable matmuls y = R_h x
    R_w^T: the JAX ``resize_bilinear_matmul``. Its backward is two matmuls
    as well, so a train step is deterministic on the card, where
    ``F.interpolate``'s backward adds with atomics."""
    rh = _interp_matrix(height, x.shape[2], x.dtype, x.device)
    rw = _interp_matrix(width, x.shape[3], x.dtype, x.device)
    return torch.matmul(torch.matmul(rh, x), rw.t())
