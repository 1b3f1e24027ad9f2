"""UpProj decoder of the port, mirroring ``radar_depth_tpu/models/
decoders.py::{UpProjBlock, Decoder}`` with the flax parameter names
(``layer{i}.branch1_conv1``, ...). The JAX package's phase and packed forms
(``models/packed.py``) are exact reassociations for the TPU's layout and are
not needed here: unpool + 5x5 conv is one transposed conv
(``layers.UnpoolConv``)."""

from __future__ import annotations

import torch
from torch import nn

from radar_depth_tpu_torch.models.layers import Conv2d, UnpoolConv, make_norm

DECODER_KINDS = ("upproj",)
NUM_LAYERS = 4


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_bn1(self.branch1_conv1(x), relu=True)
        b1 = self.branch1_conv2(b1)
        b2 = self.branch2_bn(self.branch2_conv(x))
        return self.branch1_bn2(b1, relu=True, residual=b2)


class Decoder(nn.Module):
    """Four up-blocks, each doubling the resolution and halving channels."""

    def __init__(self, kind: str = "upproj", in_channels: int = 256,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if kind not in DECODER_KINDS:
            raise ValueError(f"decoder {kind!r} is not ported; have "
                             f"{DECODER_KINDS}")
        c = in_channels
        for i in range(NUM_LAYERS):
            setattr(self, f"layer{i + 1}", UpProjBlock(c, c // 2, dtype,
                                                       param_dtype, device))
            c //= 2
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(NUM_LAYERS):
            x = getattr(self, f"layer{i + 1}")(x)
        return x
