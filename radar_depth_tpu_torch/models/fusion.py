"""Late-fusion two-branch network and the two-stage coarse->refine model,
mirroring ``radar_depth_tpu/models/fusion.py``.

Public tensors are NHWC float32, as in the JAX package: ``rgb`` (B,H,W,3),
``radar`` (B,H,W,1), predictions (B,H,W,1) (float64 for a float64 model). Inside, activations are NCHW in
channels_last memory and in the model's dtype. The JAX package's cross-stage
stem concat is a TPU lane trick with the same math and is not ported.
"""

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


class LateFusionNet(nn.Module):
    """concat(enc_img(rgb), enc_radar(radar)) at H/32 -> 1x1 conv + BN ->
    UpProj decoder -> 3x3 head -> bilinear resize to ``output_size``."""

    def __init__(self, depth: int = 18, decoder_kind: str = "upproj",
                 output_size=(450, 800), dtype=torch.float32,
                 param_dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.output_size = tuple(output_size)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.img_encoder = ResNetEncoder(depth, 3, **kw)
        self.radar_encoder = ResNetEncoder(depth, 1, **kw)
        c = self.img_encoder.out_channels
        self.conv2 = Conv2d(c + self.radar_encoder.out_channels, c // 2, 1,
                            **kw)
        self.bn2 = make_norm(c // 2, device)
        self.decoder = Decoder(decoder_kind, c // 2, **kw)
        self.conv3 = HeadConv3(self.decoder.out_channels, **kw)

    def forward(self, rgb: torch.Tensor, radar: torch.Tensor) -> torch.Tensor:
        fi = self.img_encoder(to_nchw(rgb, self.dtype))
        fr = self.radar_encoder(to_nchw(radar, self.dtype))
        y = self.bn2(self.conv2(torch.cat([fi, fr], dim=1)))
        y = self.conv3(self.decoder(y))
        y = resize_bilinear(y, *self.output_size)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        return y.permute(0, 2, 3, 1)


def filter_radar_by_prediction(radar: torch.Tensor, pred: torch.Tensor,
                               abs_threshold: float = 2.0,
                               rel_threshold: float = 0.15,
                               mode: str = "abs") -> torch.Tensor:
    """Keep radar pixel r only where |radar(r) - pred(r)| < abs_threshold
    ("abs"), < rel_threshold * pred(r) ("rel"), or either ("or"). Zero
    (no return) pixels stay zero."""
    err = (radar - pred).abs()
    keep_abs = err < abs_threshold
    keep_rel = err < rel_threshold * pred.clamp_min(1e-3)
    if mode == "abs":
        keep = keep_abs
    elif mode == "rel":
        keep = keep_rel
    elif mode == "or":
        keep = keep_abs | keep_rel
    else:
        raise ValueError(f"unknown filter mode {mode!r}")
    return torch.where((radar > 0) & keep, radar, torch.zeros_like(radar))


def blend_by_brightness(coarse: torch.Tensor, refined: torch.Tensor,
                        rgb: torch.Tensor, tau: float) -> torch.Tensor:
    """Per sample: ``refined`` where the mean RGB is below ``tau`` (dark),
    ``coarse`` where brighter."""
    bright = rgb.float().mean(dim=(1, 2, 3))
    dark = (bright < tau)[:, None, None, None]
    return torch.where(dark, refined, coarse)


FILTER_MODES = ("abs", "rel", "or")


class MultiStageNet(nn.Module):
    """Stage-1 late fusion -> coarse D1; radar filtered against D1 (no
    gradient flows into D1 through the filter); stage-2 late fusion on
    {rgb, filtered radar} -> refined D2. Returns (D1, D2)."""

    def __init__(self, depth: int = 18, decoder_kind: str = "upproj",
                 output_size=(450, 800), filter_mode: str = "abs",
                 abs_threshold: float = 2.0, rel_threshold: float = 0.15,
                 dtype=torch.float32, param_dtype=None, device=None):
        super().__init__()
        if filter_mode not in FILTER_MODES:
            raise ValueError(f"unknown filter mode {filter_mode!r}")
        self.filter_mode = filter_mode
        self.abs_threshold = abs_threshold
        self.rel_threshold = rel_threshold
        kw = dict(depth=depth, decoder_kind=decoder_kind,
                  output_size=output_size, dtype=dtype,
                  param_dtype=param_dtype, device=device)
        self.stage1 = LateFusionNet(**kw)
        self.stage2 = LateFusionNet(**kw)

    def forward(self, rgb: torch.Tensor, radar: torch.Tensor):
        coarse = self.stage1(rgb, radar)
        filtered = filter_radar_by_prediction(
            radar, coarse.detach(), abs_threshold=self.abs_threshold,
            rel_threshold=self.rel_threshold, mode=self.filter_mode)
        return coarse, self.stage2(rgb, filtered)
