"""Model zoo of the port: the architecture registry for the archs ported so
far, mirroring ``radar_depth_tpu/models/__init__.py``."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.models.decoders import DECODER_KINDS, Decoder
from radar_depth_tpu_torch.models.fusion import (
    LateFusionNet,
    MultiStageNet,
    blend_by_brightness,
    filter_radar_by_prediction,
)
from radar_depth_tpu_torch.models.layers import BatchNorm, use_plain_kernels
from radar_depth_tpu_torch.models.resnet import ResNetEncoder


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """How to build and feed a registered architecture."""

    name: str
    input_kind: str  # "late" (rgb, radar)
    multistage: bool
    build: Callable[..., Any]


def _late(depth):
    def build(decoder="upproj", output_size=(450, 800), dtype=torch.float32,
              device=None, **kw):
        return LateFusionNet(depth=depth, decoder_kind=decoder,
                             output_size=tuple(output_size), dtype=dtype,
                             device=device, **kw)
    return build


def _multi(depth):
    def build(decoder="upproj", output_size=(450, 800), dtype=torch.float32,
              device=None, **kw):
        return MultiStageNet(depth=depth, decoder_kind=decoder,
                             output_size=tuple(output_size), dtype=dtype,
                             device=device, **kw)
    return build


ARCH_REGISTRY = {
    "resnet18_latefusion": ArchSpec("resnet18_latefusion", "late", False,
                                    _late(18)),
    "resnet18_multistage": ArchSpec("resnet18_multistage", "late", True,
                                    _multi(18)),
}


def create_model(arch: str, device: str | torch.device | None = None,
                 **kwargs):
    """Build a model by registry name on ``device`` (the card unless
    ``device="cpu"``), in eval mode, with uninitialised weights (load a
    state_dict or call ``init_random``). Returns (module, spec)."""
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"arch {arch!r} is not ported; have "
                       f"{sorted(ARCH_REGISTRY)}")
    spec = ARCH_REGISTRY[arch]
    model = spec.build(device=resolve_device(device), **kwargs)
    return model.eval(), spec


def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model`` with seeded random weights: He-normal convs (fan-in),
    the 3x3 head scaled down so predictions are depth-sized (tens of
    meters), and BN affine parameters and running statistics near identity.
    Draws from a private CPU generator, never the global one."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dim() == 4:
                std = math.sqrt(2.0 / (t.shape[1] * t.shape[2] * t.shape[3]))
                if name.endswith("conv3.weight"):
                    std *= 0.05
                v = torch.randn(t.shape, generator=gen) * std
            elif name.endswith(("weight", "running_var")):
                v = torch.rand(t.shape, generator=gen) + 0.5
            else:
                v = torch.randn(t.shape, generator=gen) * 0.1
            t.copy_(v)
    return model


__all__ = [
    "ARCH_REGISTRY",
    "ArchSpec",
    "BatchNorm",
    "DECODER_KINDS",
    "Decoder",
    "LateFusionNet",
    "MultiStageNet",
    "ResNetEncoder",
    "blend_by_brightness",
    "create_model",
    "filter_radar_by_prediction",
    "init_random",
    "use_plain_kernels",
]
