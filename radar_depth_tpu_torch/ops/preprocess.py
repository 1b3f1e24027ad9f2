"""Input pipeline: raw schema batch -> model inputs, on the device.

Mirrors ``radar_depth_tpu/ops/preprocess.py`` (``PreprocessConfig``,
``prepare_eval_batch``, ``prepare_train_batch``, ``pack_model_inputs``). The
layout at these public functions stays NHWC, as in the JAX package. The
z-buffer backend is ``raster_backend``, with the JAX package's names and
default: "sorted" runs the sort and kernel C, "scatter" kernel A
(``ops/raster.py::rasterize_min_depth``); both give the same bits. With a
``sparsifier`` the sparse channel is sampled from the LiDAR target
(``ops/sparsify.py``) and no z-buffer runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.device import as_device
from radar_depth_tpu_torch.ops.augment import (
    AugmentConfig,
    apply_affine_uv,
    color_jitter,
    make_affine,
    sample_affine_params,
    warp_depths_nearest,
    warp_images_bilinear,
)
from radar_depth_tpu_torch.ops.geometry import project_points
from radar_depth_tpu_torch.ops.raster import (
    RASTER_BACKENDS,
    accumulate_sweeps,
    extend_height,
    rasterize_min_depth,
)
from radar_depth_tpu_torch.ops.sparsify import SPARSIFIERS

SPARSIFIER_NAMES = ("none",) + tuple(SPARSIFIERS)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    spec: SampleSpec = SampleSpec()
    height_extension: int = 0  # radar vertical extension (paper ablation)
    augment: AugmentConfig = AugmentConfig()
    # LiDAR GT under train-time augmentation: "warp" nearest-warps the stored
    # map through the affine and divides by s (the reference's transform);
    # "rerasterize" pushes the LiDAR points through the affine and z-buffers
    # them again (geometrically exact).
    gt_augment: str = "warp"
    raster_backend: str = "sorted"  # z-buffer: "sorted" (kernel C) | "scatter"
    # "uar" | "sim_stereo": the sparse channel is sampled from the LiDAR GT
    # (about ``num_samples`` pixels) instead of z-buffering the radar
    sparsifier: str = "none"
    num_samples: int = 200

    def __post_init__(self):
        if self.raster_backend not in RASTER_BACKENDS:
            raise ValueError(
                f"raster_backend={self.raster_backend!r}: expected 'sorted' "
                "or 'scatter'")
        if self.gt_augment not in ("warp", "rerasterize"):
            raise ValueError(
                f"gt_augment={self.gt_augment!r}: expected 'warp' or "
                "'rerasterize'")
        if self.sparsifier not in SPARSIFIER_NAMES:
            raise ValueError(f"sparsifier={self.sparsifier!r}: expected one "
                             f"of {SPARSIFIER_NAMES}")


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Raw schema batch of numpy arrays (or tensors) -> tensors on
    ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.require(v, requirements="W"), device=device)
            for k, v in batch.items()}


def _radar_uvz(batch: Dict[str, torch.Tensor]):
    pts_cam, valid = accumulate_sweeps(batch["radar_points"],
                                       batch["radar_valid"],
                                       batch["radar_transform"])
    uv, z = project_points(pts_cam, batch["intrinsics"])
    return uv, z, valid


def _lidar_uvz(batch: Dict[str, torch.Tensor]):
    uv, z = project_points(batch["lidar_points"], batch["intrinsics"])
    return uv, z, batch["lidar_valid"]


def _raster(uv, z, valid, cfg: PreprocessConfig, height_extension: int,
            plain: bool):
    if height_extension > 0:
        offsets = torch.arange(-height_extension, height_extension + 1,
                               device=uv.device)
        uv, z, valid = extend_height(uv, z, valid, offsets)
    spec = cfg.spec
    return rasterize_min_depth(uv, z, valid, spec.height, spec.width,
                               min_depth=spec.min_depth,
                               max_depth=spec.max_depth,
                               backend=cfg.raster_backend,
                               plain=plain)[..., None]


def _rgb(b: Dict[str, torch.Tensor], dev: torch.device) -> torch.Tensor:
    # Divide by a device tensor, not a Python number: CUDA turns x / scalar
    # into x * (1/scalar), which is off by an ulp for some pixels. The
    # tensor is filled on the device: a copy from the host would wait for
    # the stream.
    return b["image"].to(torch.float32) / torch.full((), 255.0, device=dev)


def prepare_eval_batch(batch: Dict, cfg: PreprocessConfig,
                       device: str | torch.device | None = None,
                       plain: bool = False,
                       sparse_u: torch.Tensor | None = None,
                       generator: torch.Generator | None = None
                       ) -> Dict[str, torch.Tensor]:
    """Validation-path inputs, no augmentation.

    Returns {rgb (B,H,W,3) float32 in [0,1], radar (B,H,W,1), target
    (B,H,W,1)} on ``device`` (the card unless ``device="cpu"``).
    ``plain=True`` runs the z-buffer's plain version (the reference on the
    card). With ``cfg.sparsifier`` the "radar" channel is the sparsified
    target: its uniform draws are ``sparse_u`` (B,H,W), else drawn from
    ``generator``, else from a generator seeded 0 (the same draws for every
    batch, as the JAX package's fixed key).
    """
    dev = as_device(device)
    b = to_device(batch, dev)
    target = b["lidar_depth"][..., None].to(torch.float32)
    if cfg.sparsifier != "none":
        if sparse_u is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        radar = SPARSIFIERS[cfg.sparsifier](
            target[..., 0], cfg.num_samples,
            u=None if sparse_u is None else torch.as_tensor(sparse_u,
                                                            device=dev),
            generator=generator)[..., None]
    else:
        radar = _raster(*_radar_uvz(b), cfg, cfg.height_extension, plain)
    return {"rgb": _rgb(b, dev), "radar": radar, "target": target}


def prepare_train_batch(batch: Dict, cfg: PreprocessConfig,
                        aug_params: Tuple | None = None,
                        generator: torch.Generator | None = None,
                        device: str | torch.device | None = None,
                        plain: bool = False,
                        sparse_u: torch.Tensor | None = None
                        ) -> Dict[str, torch.Tensor]:
    """Training-path inputs with on-device augmentation: per sample a random
    scale s in [1, 1.5], rotation of +-5 degrees, horizontal flip and color
    jitter; the image is warped bilinearly, radar (and with
    ``gt_augment="rerasterize"`` the LiDAR GT) is projected through the same
    affine and z-buffered again, depths divided by s.

    The parameters are ``aug_params`` = (scale, angle, flip, jitter), as
    ``ops/augment.py::sample_affine_params`` returns them, or are drawn from
    ``generator``; one of the two is needed when ``cfg.augment.enabled``.
    Returns the dict of ``prepare_eval_batch``.

    With ``cfg.sparsifier`` the batch takes the eval path, unaugmented, its
    draws ``sparse_u`` or drawn from ``generator`` (one of the two is
    needed), as the JAX package trains that modality.
    """
    if cfg.sparsifier != "none":
        if sparse_u is None and generator is None:
            raise ValueError("a sparsifier needs sparse_u or a generator")
        return prepare_eval_batch(batch, cfg, device, plain, sparse_u,
                                  generator)
    dev = as_device(device)
    b = to_device(batch, dev)
    rgb = _rgb(b, dev)
    if not cfg.augment.enabled:
        radar = _raster(*_radar_uvz(b), cfg, cfg.height_extension, plain)
        target = (b["lidar_depth"][..., None].to(torch.float32)
                  if cfg.gt_augment == "warp"
                  else _raster(*_lidar_uvz(b), cfg, 0, plain))
        return {"rgb": rgb, "radar": radar, "target": target}

    if aug_params is None:
        if generator is None:
            raise ValueError("augmentation needs aug_params or a generator")
        aug_params = sample_affine_params(generator, cfg.augment,
                                          rgb.shape[0])
    scale, angle, flip, jitter = (torch.as_tensor(p, device=dev)
                                  for p in aug_params)
    spec = cfg.spec
    A = make_affine(scale, angle, flip, spec.height, spec.width)
    rgb = color_jitter(warp_images_bilinear(rgb, A), jitter)

    def aug_raster(uv, z, valid, height_extension):
        uv = apply_affine_uv(A, uv)
        z = z / scale[:, None]  # zoom in by s => depth / s (reference rule)
        return _raster(uv, z, valid, cfg, height_extension, plain)

    radar = aug_raster(*_radar_uvz(b), cfg.height_extension)
    if cfg.gt_augment == "warp":
        target = warp_depths_nearest(b["lidar_depth"].to(torch.float32), A,
                                     scale)[..., None]
    else:
        target = aug_raster(*_lidar_uvz(b), 0)
    return {"rgb": rgb, "radar": radar, "target": target}


def pack_model_inputs(prepared: Dict[str, torch.Tensor], input_kind: str,
                      modality: str = "rgbd") -> Tuple:
    """Model positional inputs from a prepared batch: (rgb, radar) for the
    late-fusion archs; for the single-branch ones (rgb,), (concat(rgb,
    radar),) or (radar,) by ``modality`` (rgb | rgbd | d)."""
    rgb, radar = prepared["rgb"], prepared["radar"]
    if input_kind == "late":
        return rgb, radar
    if input_kind != "single":
        raise ValueError(f"unknown input kind {input_kind!r}")
    if modality == "rgb":
        return (rgb,)
    if modality == "rgbd":
        return (torch.cat([rgb, radar], dim=-1),)
    if modality == "d":
        return (radar,)
    raise ValueError(f"unknown modality {modality!r}")
