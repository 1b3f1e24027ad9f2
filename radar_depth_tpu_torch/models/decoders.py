"""Decoders of the port, mirroring ``radar_depth_tpu/models/decoders.py::
{DeConvBlock, UpConvBlock, UpProjBlock, Decoder}`` with the flax parameter
names (``layer{i}.convt``, ``layer{i}.conv``, ``layer{i}.branch1_conv1``,
...). The JAX package's phase and packed forms (``models/packed.py``) are
exact reassociations for the TPU's layout and are not needed here: unpool +
5x5 conv is one transposed conv (``layers.UnpoolConv``)."""

from __future__ import annotations

import torch
from torch import nn

from radar_depth_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose,
    UnpoolConv,
    make_norm,
)

DECODER_KINDS = ("deconv2", "deconv3", "upconv", "upproj")
NUM_LAYERS = 4


class DeConvBlock(nn.Module):
    """ConvTranspose2d(k, stride 2, padding (k-1)//2, output_padding k%2,
    so the size exactly doubles) -> BN -> ReLU; the BN->ReLU is kernel B in
    eval mode."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        k = kernel_size
        self.convt = ConvTranspose(cin, features, k, 2, (k - 1) // 2, k % 2,
                                   dtype=dtype, param_dtype=param_dtype,
                                   device=device)
        self.bn = make_norm(features, device)

    def plan_rows(self, h: int) -> int:
        return self.bn.plan_rows(self.convt.plan_rows(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.convt(x), relu=True)


class UpConvBlock(nn.Module):
    """Unpool -> 5x5 conv (one transposed conv) -> BN -> ReLU; the BN->ReLU
    is kernel B in eval mode."""

    def __init__(self, cin: int, features: int, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.conv = UnpoolConv(cin, features, 5, dtype=dtype,
                               param_dtype=param_dtype, device=device)
        self.bn = make_norm(features, device)

    def plan_rows(self, h: int) -> int:
        return self.bn.plan_rows(self.conv.plan_rows(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), relu=True)


class UpProjBlock(nn.Module):
    """Laina up-projection: unpool, then {5x5-BN-ReLU-3x3-BN} + {5x5-BN},
    add, ReLU. In eval mode ``branch1_bn1``+ReLU and ``relu(branch1_bn2(.) +
    branch2_bn(.))`` are kernel B; ``branch2_bn`` is a plain BN computed
    first."""

    def __init__(self, cin: int, features: int, dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        conv = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.branch1_conv1 = UnpoolConv(cin, features, 5, **conv)
        self.branch1_bn1 = make_norm(features, device)
        self.branch1_conv2 = Conv2d(features, features, 3, 1, 1, **conv)
        self.branch1_bn2 = make_norm(features, device)
        self.branch2_conv = UnpoolConv(cin, features, 5, **conv)
        self.branch2_bn = make_norm(features, device)

    def plan_rows(self, h: int) -> int:
        h1 = self.branch1_bn1.plan_rows(self.branch1_conv1.plan_rows(h))
        self.branch1_bn2.plan_rows(self.branch1_conv2.plan_rows(h1))
        self.branch2_bn.plan_rows(self.branch2_conv.plan_rows(h))
        return h1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_bn1(self.branch1_conv1(x), relu=True)
        b1 = self.branch1_conv2(b1)
        b2 = self.branch2_bn(self.branch2_conv(x))
        return self.branch1_bn2(b1, relu=True, residual=b2)


class Decoder(nn.Module):
    """Four up-blocks of ``kind``, each doubling the resolution and halving
    the channels."""

    def __init__(self, kind: str = "upproj", in_channels: int = 256,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if kind not in DECODER_KINDS:
            raise ValueError(f"decoder {kind!r}: expected one of "
                             f"{DECODER_KINDS}")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        c = in_channels
        for i in range(NUM_LAYERS):
            if kind == "deconv2":
                block = DeConvBlock(c, c // 2, 2, **kw)
            elif kind == "deconv3":
                block = DeConvBlock(c, c // 2, 3, **kw)
            elif kind == "upconv":
                block = UpConvBlock(c, c // 2, **kw)
            else:
                block = UpProjBlock(c, c // 2, **kw)
            setattr(self, f"layer{i + 1}", block)
            c //= 2
        self.out_channels = c

    def plan_rows(self, h: int) -> int:
        for i in range(NUM_LAYERS):
            h = getattr(self, f"layer{i + 1}").plan_rows(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(NUM_LAYERS):
            x = getattr(self, f"layer{i + 1}")(x)
        return x
