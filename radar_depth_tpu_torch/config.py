"""Configuration of the port: the subsets of the JAX package's config tree
(``radar_depth_tpu/config.py``) that the serving path (``ServeConfig``) and
the train and eval steps (``TrainConfig``) read, with the same names and
defaults."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from radar_depth_tpu_torch.data.schema import SampleSpec
from radar_depth_tpu_torch.ops.augment import AugmentConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_dtype(dtype: str) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"dtype={dtype!r}: expected one of {sorted(DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    arch: str = "resnet18_latefusion"
    decoder: str = "upproj"
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    height: int = 450
    width: int = 800
    num_sweeps: int = 5
    max_depth: float = 80.0
    height_extension: int = 0
    raster_backend: str = "sorted"  # z-buffer: sorted (kernel C) | scatter
    # two-stage radar filter (multistage archs)
    filter_mode: str = "abs"
    abs_threshold: float = 2.0
    rel_threshold: float = 0.15
    # >0: emit refined where the mean RGB < tau, coarse where brighter
    blend_tau: float = 0.0

    def __post_init__(self):
        _check_dtype(self.dtype)

    def sample_spec(self) -> SampleSpec:
        return SampleSpec(height=self.height, width=self.width,
                          num_sweeps=self.num_sweeps, max_depth=self.max_depth)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    height: int = 450
    width: int = 800
    num_sweeps: int = 5
    max_depth: float = 80.0
    height_extension: int = 0
    raster_backend: str = "sorted"  # z-buffer: sorted (kernel C) | scatter
    # LiDAR GT under train augmentation: warp | rerasterize
    gt_augment: str = "warp"

    def sample_spec(self) -> SampleSpec:
        return SampleSpec(height=self.height, width=self.width,
                          num_sweeps=self.num_sweeps, max_depth=self.max_depth)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "resnet18_latefusion"
    decoder: str = "upproj"
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    filter_mode: str = "abs"
    abs_threshold: float = 2.0
    rel_threshold: float = 0.15
    blend_tau: float = 0.0

    def __post_init__(self):
        _check_dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_decay_epochs: int = 5  # step decay x factor every N epochs
    lr_decay_factor: float = 0.1
    criterion: str = "l1"  # l1 | l2
    stage_weights: Tuple[float, float] = (1.0, 1.0)
    # micro-batches averaged per optimizer step; BN statistics update per
    # micro-batch
    grad_accum: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    augment: AugmentConfig = AugmentConfig()
    batch_size: int = 8
    # "batch": the reference's AverageMeter weighting; "sample": per-sample
    # means (see metrics.py)
    metric_avg: str = "batch"
