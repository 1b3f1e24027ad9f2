"""Serving configuration of the port: the subset of the JAX package's
``TrainConfig`` (``radar_depth_tpu/config.py``) that the serving path reads,
with the same defaults."""

from __future__ import annotations

import dataclasses

import torch

from radar_depth_tpu_torch.data.schema import SampleSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    # two-stage radar filter (multistage archs)
    filter_mode: str = "abs"
    abs_threshold: float = 2.0
    rel_threshold: float = 0.15
    # >0: emit refined where the mean RGB < tau, coarse where brighter
    blend_tau: float = 0.0

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype={self.dtype!r}: expected one of "
                             f"{sorted(DTYPES)}")

    def sample_spec(self) -> SampleSpec:
        return SampleSpec(height=self.height, width=self.width,
                          num_sweeps=self.num_sweeps, max_depth=self.max_depth)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]
