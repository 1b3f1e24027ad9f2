"""Eval-path input pipeline: raw schema batch -> model inputs, on the device.

Mirrors the eval half of ``radar_depth_tpu/ops/preprocess.py``
(``PreprocessConfig``, ``prepare_eval_batch``, ``pack_model_inputs``). The
layout at these public functions stays NHWC, as in the JAX package. The
z-buffer is kernel A (``ops/kernels.py``); both JAX raster backends give the
same bits, so there is no backend option.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.device import resolve_device
from radar_depth_tpu_torch.ops.geometry import project_points
from radar_depth_tpu_torch.ops.raster import (
    accumulate_sweeps,
    extend_height,
    rasterize_min_depth,
)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    spec: SampleSpec = SampleSpec()
    height_extension: int = 0  # radar vertical extension (paper ablation)


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Raw schema batch of numpy arrays -> tensors on ``device``."""
    return {k: torch.as_tensor(np.require(v, requirements="W"), device=device)
            for k, v in batch.items()}


def _radar_uvz(batch: Dict[str, torch.Tensor]):
    pts_cam, valid = accumulate_sweeps(batch["radar_points"],
                                       batch["radar_valid"],
                                       batch["radar_transform"])
    uv, z = project_points(pts_cam, batch["intrinsics"])
    return uv, z, valid


def _raster(uv, z, valid, spec: SampleSpec, height_extension: int,
            plain: bool):
    if height_extension > 0:
        offsets = torch.arange(-height_extension, height_extension + 1,
                               device=uv.device)
        uv, z, valid = extend_height(uv, z, valid, offsets)
    return rasterize_min_depth(uv, z, valid, spec.height, spec.width,
                               min_depth=spec.min_depth,
                               max_depth=spec.max_depth, plain=plain)[..., None]


def prepare_eval_batch(batch: Dict, cfg: PreprocessConfig,
                       device: str | torch.device | None = None,
                       plain: bool = False) -> Dict[str, torch.Tensor]:
    """Validation-path inputs, no augmentation.

    Returns {rgb (B,H,W,3) float32 in [0,1], radar (B,H,W,1), target
    (B,H,W,1)} on ``device`` (the card unless ``device="cpu"``).
    ``plain=True`` runs the z-buffer's plain version (the reference on the
    card).
    """
    dev = resolve_device(device)
    b = to_device(batch, dev)
    # Divide by a device tensor, not a Python number: CUDA turns x / scalar
    # into x * (1/scalar), which is off by an ulp for some pixels.
    rgb = b["image"].to(torch.float32) / torch.tensor(255.0, device=dev)
    target = b["lidar_depth"][..., None].to(torch.float32)
    radar = _raster(*_radar_uvz(b), cfg.spec, cfg.height_extension, plain)
    return {"rgb": rgb, "radar": radar, "target": target}


def pack_model_inputs(prepared: Dict[str, torch.Tensor],
                      input_kind: str) -> Tuple:
    """Model positional inputs from a prepared batch: (rgb, radar) for the
    late-fusion archs, the only ones ported so far (the single-branch
    modalities wait for the rest of the zoo)."""
    if input_kind != "late":
        raise ValueError(f"input kind {input_kind!r} is not ported")
    return prepared["rgb"], prepared["radar"]
