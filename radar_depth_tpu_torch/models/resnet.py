"""ResNet-18/34/50 encoders of the port (torchvision BasicBlock and
Bottleneck stacks), mirroring ``radar_depth_tpu/models/resnet.py`` with the
same parameter names (``conv1``, ``bn1``, ``layer{stage}_{block}.{conv1,bn1,
conv2,bn2[,conv3,bn3],downsample_conv,downsample_bn}``)."""

from __future__ import annotations

import torch
from torch import nn

from radar_depth_tpu_torch.models.layers import (
    Conv2d,
    make_norm,
    max_pool_torch,
    pool_rows,
)

STAGE_SIZES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
BOTTLENECK_EXPANSION = 4  # torchvision Bottleneck: output = 4 * planes
WIDTH = 64  # stem width of both branches, as the reference builds them


class BasicBlock(nn.Module):
    """3x3-BN-ReLU-3x3-BN + identity/1x1 shortcut, ReLU. In eval mode both
    BN->ReLU sites are kernel B; the second takes the shortcut as its
    residual (a ``downsample_bn`` shortcut is a plain BN, computed first)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        conv = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv1 = Conv2d(cin, features, 3, stride, 1, **conv)
        self.bn1 = make_norm(features, device)
        self.conv2 = Conv2d(features, features, 3, 1, 1, **conv)
        self.bn2 = make_norm(features, device)
        self.has_downsample = cin != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, features, 1, stride, **conv)
            self.downsample_bn = make_norm(features, device)

    def plan_rows(self, h: int) -> int:
        """Record the global heights of the block's ops (spatial mode);
        returns the output's."""
        h1 = self.bn1.plan_rows(self.conv1.plan_rows(h))
        self.bn2.plan_rows(self.conv2.plan_rows(h1))
        if self.has_downsample:
            self.downsample_bn.plan_rows(self.downsample_conv.plan_rows(h))
        return h1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), relu=True)
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return self.bn2(self.conv2(y), relu=True, residual=x)


class Bottleneck(nn.Module):
    """torchvision Bottleneck, ResNet V1.5 (the stride on the 3x3):
    1x1-BN-ReLU, 3x3(s)-BN-ReLU, 1x1(x4)-BN + identity/1x1 shortcut, ReLU.
    In eval mode ``bn1`` and ``bn2`` are kernel B without a residual and
    ``bn3`` kernel B with the shortcut as its residual (a ``downsample_bn``
    shortcut is a plain BN, computed first)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        conv = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        out = features * BOTTLENECK_EXPANSION
        self.conv1 = Conv2d(cin, features, 1, **conv)
        self.bn1 = make_norm(features, device)
        self.conv2 = Conv2d(features, features, 3, stride, 1, **conv)
        self.bn2 = make_norm(features, device)
        self.conv3 = Conv2d(features, out, 1, **conv)
        self.bn3 = make_norm(out, device)
        self.has_downsample = cin != out or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, out, 1, stride, **conv)
            self.downsample_bn = make_norm(out, device)

    def plan_rows(self, h: int) -> int:
        h1 = self.bn1.plan_rows(self.conv1.plan_rows(h))
        h2 = self.bn2.plan_rows(self.conv2.plan_rows(h1))
        self.bn3.plan_rows(self.conv3.plan_rows(h2))
        if self.has_downsample:
            self.downsample_bn.plan_rows(self.downsample_conv.plan_rows(h))
        return h2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), relu=True)
        y = self.bn2(self.conv2(y), relu=True)
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return self.bn3(self.conv3(y), relu=True, residual=x)


class ResNetEncoder(nn.Module):
    """conv1 -> bn1+relu -> maxpool -> layer1..layer4; returns the H/32
    feature map (512 channels for depths 18 and 34, 2048 for 50).
    ``stem_conv`` / ``stem_finish`` / ``body`` are the same pieces as in the
    JAX encoder."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise ValueError(f"ResNet depth {depth}: expected one of "
                             f"{sorted(STAGE_SIZES)}")
        self.in_channels = in_channels
        self.mesh = None  # of the max pool, in spatial mode (use_mesh)
        self.pool_rows = None  # the pool's global input height
        self.conv1 = Conv2d(in_channels, WIDTH, 7, 2, 3, dtype=dtype,
                            param_dtype=param_dtype, device=device)
        self.bn1 = make_norm(WIDTH, device)
        block_cls, exp = ((Bottleneck, BOTTLENECK_EXPANSION) if depth >= 50
                          else (BasicBlock, 1))
        self.block_names = []
        cin = WIDTH
        for stage, num_blocks in enumerate(STAGE_SIZES[depth]):
            features = WIDTH * 2 ** stage
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                setattr(self, name, block_cls(cin, features, stride, dtype,
                                              param_dtype, device))
                self.block_names.append(name)
                cin = features * exp
        self.out_channels = cin

    def plan_rows(self, h: int) -> int:
        self.pool_rows = self.bn1.plan_rows(self.conv1.plan_rows(h))
        h = pool_rows(self.pool_rows)
        for name in self.block_names:
            h = getattr(self, name).plan_rows(h)
        return h

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {x.shape[1]}")
        return self.conv1(x)

    def stem_finish(self, y: torch.Tensor) -> torch.Tensor:
        """BN + ReLU on the stem conv output (pre-pool); kernel B in eval
        mode."""
        return self.bn1(y, relu=True)

    def body(self, p: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            p = getattr(self, name)(p)
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem_finish(self.stem_conv(x))
        return self.body(max_pool_torch(y, 3, 2, 1, self.mesh,
                                        self.pool_rows))
