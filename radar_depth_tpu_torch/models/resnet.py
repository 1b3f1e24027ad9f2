"""ResNet-18 encoder of the port (torchvision BasicBlock stacks), mirroring
``radar_depth_tpu/models/resnet.py`` with the same parameter names
(``conv1``, ``bn1``, ``layer{stage}_{block}.{conv1,bn1,conv2,bn2,
downsample_conv,downsample_bn}``). Only depth 18 is ported so far."""

from __future__ import annotations

import torch
from torch import nn

from radar_depth_tpu_torch.models.layers import Conv2d, make_norm, max_pool_torch

STAGE_SIZES = {18: (2, 2, 2, 2)}
WIDTH = 64  # stem width of both branches, as the reference builds them


class BasicBlock(nn.Module):
    """3x3-BN-ReLU-3x3-BN + identity/1x1 shortcut, ReLU. Both BN->ReLU sites
    are kernel B; the second takes the shortcut as its residual (a
    ``downsample_bn`` shortcut is a plain BN, computed first)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        self.conv1 = Conv2d(cin, features, 3, stride, 1, **conv)
        self.bn1 = make_norm(features, device)
        self.conv2 = Conv2d(features, features, 3, 1, 1, **conv)
        self.bn2 = make_norm(features, device)
        self.has_downsample = cin != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(cin, features, 1, stride, **conv)
            self.downsample_bn = make_norm(features, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x), relu=True)
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return self.bn2(self.conv2(y), relu=True, residual=x)


class ResNetEncoder(nn.Module):
    """conv1 -> bn1+relu -> maxpool -> layer1..layer4; returns the H/32
    feature map (512 channels). ``stem_conv`` / ``stem_finish`` / ``body``
    are the same pieces as in the JAX encoder."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 dtype=torch.float32, device=None):
        super().__init__()
        if depth not in STAGE_SIZES:
            raise ValueError(f"ResNet depth {depth} is not ported; have "
                             f"{sorted(STAGE_SIZES)}")
        self.in_channels = in_channels
        self.conv1 = Conv2d(in_channels, WIDTH, 7, 2, 3, dtype=dtype,
                            device=device)
        self.bn1 = make_norm(WIDTH, device)
        self.block_names = []
        cin = WIDTH
        for stage, num_blocks in enumerate(STAGE_SIZES[depth]):
            features = WIDTH * 2 ** stage
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                setattr(self, name, BasicBlock(cin, features, stride, dtype,
                                               device))
                self.block_names.append(name)
                cin = features
        self.out_channels = cin

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, "
                             f"got {x.shape[1]}")
        return self.conv1(x)

    def stem_finish(self, y: torch.Tensor) -> torch.Tensor:
        """BN + ReLU on the stem conv output (pre-pool): kernel B."""
        return self.bn1(y, relu=True)

    def body(self, p: torch.Tensor) -> torch.Tensor:
        for name in self.block_names:
            p = getattr(self, name)(p)
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem_finish(self.stem_conv(x))
        return self.body(max_pool_torch(y, 3, 2, 1))
