"""Model zoo of the port: the architecture registry, mirroring
``radar_depth_tpu/models/__init__.py`` entry for entry.

  resnet18 / resnet34 / resnet50        single branch (``DepthNet``); input
                                        channels from ``modality`` (rgb 3,
                                        rgbd 4 early fusion, d 1)
  resnet{18,34,50}_latefusion           two-branch late fusion (rgb, radar)
  resnet{18,34,50}_multistage           two-stage coarse -> refine
  resnet{18,34}_multistage_uncertainty  the same with learned per-stage
                                        log-variances
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.models.decoders import DECODER_KINDS, Decoder
from radar_depth_tpu_torch.models.depth_net import DepthNet
from radar_depth_tpu_torch.models.fusion import (
    LateFusionNet,
    MultiStageNet,
    blend_by_brightness,
    filter_radar_by_prediction,
)
from radar_depth_tpu_torch.models.layers import (
    BatchNorm,
    HeadConv3,
    use_mesh,
    use_plain_kernels,
)
from radar_depth_tpu_torch.models.resnet import ResNetEncoder

MODALITY_CHANNELS = {"rgb": 3, "rgbd": 4, "d": 1}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """How to build and feed a registered architecture."""

    name: str
    input_kind: str  # "single" (one NHWC tensor) | "late" (rgb, radar)
    multistage: bool
    build: Callable[..., Any]


def _single(depth):
    def build(modality="rgbd", decoder="upproj", output_size=(450, 800),
              dtype=torch.float32, device=None, **kw):
        return DepthNet(depth=depth, in_channels=MODALITY_CHANNELS[modality],
                        decoder_kind=decoder, output_size=tuple(output_size),
                        dtype=dtype, device=device, **kw)
    return build


def _late(depth):
    def build(decoder="upproj", output_size=(450, 800), dtype=torch.float32,
              device=None, modality=None, **kw):
        return LateFusionNet(depth=depth, decoder_kind=decoder,
                             output_size=tuple(output_size), dtype=dtype,
                             device=device, **kw)
    return build


def _multi(depth, uncertainty=False):
    def build(decoder="upproj", output_size=(450, 800), dtype=torch.float32,
              device=None, modality=None, **kw):
        return MultiStageNet(depth=depth, decoder_kind=decoder,
                             output_size=tuple(output_size), dtype=dtype,
                             device=device, uncertainty=uncertainty, **kw)
    return build


ARCH_REGISTRY = {
    "resnet18": ArchSpec("resnet18", "single", False, _single(18)),
    "resnet34": ArchSpec("resnet34", "single", False, _single(34)),
    "resnet50": ArchSpec("resnet50", "single", False, _single(50)),
    "resnet18_latefusion": ArchSpec("resnet18_latefusion", "late", False,
                                    _late(18)),
    "resnet34_latefusion": ArchSpec("resnet34_latefusion", "late", False,
                                    _late(34)),
    "resnet50_latefusion": ArchSpec("resnet50_latefusion", "late", False,
                                    _late(50)),
    "resnet18_multistage": ArchSpec("resnet18_multistage", "late", True,
                                    _multi(18)),
    "resnet34_multistage": ArchSpec("resnet34_multistage", "late", True,
                                    _multi(34)),
    "resnet50_multistage": ArchSpec("resnet50_multistage", "late", True,
                                    _multi(50)),
    "resnet18_multistage_uncertainty": ArchSpec(
        "resnet18_multistage_uncertainty", "late", True,
        _multi(18, uncertainty=True)),
    "resnet34_multistage_uncertainty": ArchSpec(
        "resnet34_multistage_uncertainty", "late", True,
        _multi(34, uncertainty=True)),
}


def create_model(arch: str, device: str | torch.device | None = None,
                 **kwargs):
    """Build a model by registry name on ``device`` (the card unless
    ``device="cpu"``), in eval mode, with uninitialised weights (load a
    state_dict or call ``init_random``). Returns (module, spec).

    ``dtype`` is the compute dtype; ``param_dtype`` (default: ``dtype``) the
    dtype the conv weights are held in: training in bfloat16 keeps float32
    weights and casts them per call, serving casts them once at load."""
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; have "
                       f"{sorted(ARCH_REGISTRY)}")
    spec = ARCH_REGISTRY[arch]
    model = spec.build(device=resolve_device(device), **kwargs)
    return model.eval(), spec


def head_weight_names(model: nn.Module) -> set:
    """The state_dict names of the 3x3 head kernels (``conv3`` of each
    stage or net; a Bottleneck's 1x1 ``conv3`` is not one)."""
    return {f"{n}.weight" for n, m in model.named_modules()
            if isinstance(m, HeadConv3)}


def init_random(model: nn.Module, seed: int) -> nn.Module:
    """Fill ``model`` with seeded random weights: He-normal convs (fan-in),
    the 3x3 head scaled down so predictions are depth-sized (tens of
    meters), and BN affine parameters and running statistics near identity.
    The uncertainty archs' ``stage_log_var`` is zero, as flax initialises
    it. Draws from a private CPU generator, never the global one."""
    gen = torch.Generator().manual_seed(seed)
    heads = head_weight_names(model)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name == "stage_log_var":
                v = torch.zeros(t.shape)
            elif t.dim() == 4:
                std = math.sqrt(2.0 / (t.shape[1] * t.shape[2] * t.shape[3]))
                if name in heads:
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
    "DepthNet",
    "LateFusionNet",
    "MODALITY_CHANNELS",
    "MultiStageNet",
    "ResNetEncoder",
    "blend_by_brightness",
    "create_model",
    "filter_radar_by_prediction",
    "head_weight_names",
    "init_random",
    "use_mesh",
    "use_plain_kernels",
]
