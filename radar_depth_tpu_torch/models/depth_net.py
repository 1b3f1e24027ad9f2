"""Single-branch depth network (RGB, RGBD early fusion, or D), mirroring
``radar_depth_tpu/models/depth_net.py::DepthNet``: encoder -> 1x1 conv ->
BN -> decoder -> 3x3 head -> bilinear resize to ``output_size``.

The input is one NHWC float32 tensor, (B,H,W,``in_channels``): rgb (3),
concat(rgb, sparse depth) (4) or the sparse depth alone (1); the prediction
is (B,H,W,1) (float64 for a float64 model)."""

from __future__ import annotations

import torch
from torch import nn

from radar_depth_tpu_torch.models.decoders import Decoder
from radar_depth_tpu_torch.models.layers import (
    Conv2d,
    HeadConv3,
    make_norm,
    resize_bilinear,
    to_nchw,
)
from radar_depth_tpu_torch.models.resnet import ResNetEncoder


class DepthNet(nn.Module):
    """Encoder-decoder sparse-to-dense network on one input tensor."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 decoder_kind: str = "upproj", output_size=(450, 800),
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.output_size = tuple(output_size)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.encoder = ResNetEncoder(depth, in_channels, **kw)
        c = self.encoder.out_channels
        self.conv2 = Conv2d(c, c // 2, 1, **kw)
        self.bn2 = make_norm(c // 2, device)
        self.decoder = Decoder(decoder_kind, c // 2, **kw)
        self.conv3 = HeadConv3(self.decoder.out_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(self.encoder(to_nchw(x, self.dtype))))
        y = resize_bilinear(self.conv3(self.decoder(y)), *self.output_size)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return y.permute(0, 2, 3, 1)
