"""Low-level layers of the port, eval-mode, NCHW tensors in channels_last
memory (NHWC bytes, as the JAX package and kernel B use).

Mirrors ``radar_depth_tpu/models/layers.py``. Convolutions go to cuDNN
through ``torch.nn.functional``; every BN that is followed by a ReLU runs as
kernel B (``ops/kernels.py::scale_bias_relu``), with its optional residual.

Parameter names follow the flax tree: a conv's ``kernel`` is ``weight``
(OIHW), a BN's ``scale``/``bias`` are ``weight``/``bias`` and its
``batch_stats`` ``mean``/``var`` are ``running_mean``/``running_var``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from radar_depth_tpu_torch.ops import kernels


def _param(shape, dtype, device, channels_last=False) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    return nn.Parameter(t, requires_grad=False)


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC tensor -> NCHW view in channels_last memory, in ``dtype``."""
    return x.permute(0, 3, 1, 2).to(dtype)


class Conv2d(nn.Module):
    """Bias-free conv with torch-style symmetric padding. The weight is held
    in the model's compute dtype, so loading a float32 state_dict casts it
    once, as the JAX package casts its kernel per call."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _param((cout, cin, kernel_size, kernel_size), dtype,
                             device, channels_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=self.stride,
                        padding=self.padding)


class HeadConv3(Conv2d):
    """Final 3x3 conv -> 1 channel (flax ``HeadConv3``, param ``kernel``)."""

    def __init__(self, cin: int, dtype=torch.float32, device=None):
        super().__init__(cin, 1, 3, 1, 1, dtype=dtype, device=device)


class UnpoolConv(Conv2d):
    """Zero-insertion stride-2 unpool followed by a KxK conv with padding
    K//2, computed as one transposed conv (the zeros never exist): with the
    kernel flipped and its in/out axes swapped, ``conv_transpose2d(stride 2,
    padding K//2, output_padding 1)`` is exactly ``conv(unpool(x))``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 dtype=torch.float32, device=None):
        super().__init__(cin, cout, kernel_size, 1, kernel_size // 2,
                         dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        w = self.weight.flip((2, 3)).transpose(0, 1)
        return F.conv_transpose2d(x, w, stride=2, padding=k // 2,
                                  output_padding=2 * (k // 2) + 2 - k)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm. The folded ``scale = gamma/sqrt(var+eps)`` and
    ``bias = beta - mean*scale`` are float32; the output is in x's dtype.

    ``forward(x, relu=True, residual=r)`` is ``relu(bn(x) + r)`` through
    kernel B; without ``relu`` the BN is plain PyTorch. ``plain=True`` sends
    kernel B's sites to its plain version on any device (the reference on
    the card, set by ``use_plain_kernels``)."""

    def __init__(self, channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.plain = False
        self.weight = _param((channels,), torch.float32, device)
        self.bias = _param((channels,), torch.float32, device)
        self.register_buffer("running_mean", torch.empty(
            channels, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.empty(
            channels, dtype=torch.float32, device=device))

    def folded(self):
        scale = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        scale, bias = self.folded()
        if relu:
            fn = (kernels.scale_bias_relu_reference if self.plain
                  else kernels.scale_bias_relu)
            return fn(x, scale, bias, residual)
        if residual is not None:
            raise ValueError("a residual is added only before a ReLU")
        y = x.float() * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def make_norm(channels: int, device=None) -> BatchNorm:
    """The model's BatchNorm: torch ``BatchNorm2d(eps=1e-5)`` in eval mode
    (the flax ``make_norm``; momentum matters only in training)."""
    return BatchNorm(channels, epsilon=1e-5, device=device)


def use_plain_kernels(model: nn.Module, plain: bool = True) -> nn.Module:
    """Route every kernel-B site of ``model`` to the plain version."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.plain = plain
    return model


def max_pool_torch(x: torch.Tensor, window: int = 3, stride: int = 2,
                   padding: int = 1) -> torch.Tensor:
    """MaxPool2d(window, stride, padding), floor mode, -inf padding."""
    return F.max_pool2d(x, window, stride, padding)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and edge clamping
    (align_corners=False), in x's dtype: the JAX ``resize_bilinear_matmul``."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False)
