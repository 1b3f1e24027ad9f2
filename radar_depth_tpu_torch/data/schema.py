"""Sample schema: the contract between data generation and the serving path.

The port's own copy of ``radar_depth_tpu/data/schema.py`` (numpy only), so
that the PyTorch package imports nothing of the JAX package. Samples carry
the raw multi-sweep radar points (padded, with masks) plus the per-sweep
cam<-sensor SE(3) chain; projection and the z-buffer run on the device.
Everything is fixed-shape: batches are plain stacked arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

# Fixed buffer sizes (per sample). nuScenes RADAR_FRONT returns ≤125 points per
# sweep (hardware limit of the continental ARS408); LiDAR ~30-35k points hit
# the front camera frustum. Padded generously; masks make padding free.
MAX_RADAR_POINTS_PER_SWEEP = 128
MAX_LIDAR_POINTS = 40960
DEFAULT_NUM_SWEEPS = 5

# Native nuScenes CAM_FRONT resolution and the model working resolution
# (reference downsamples ×2 then crops; SURVEY.md §7 step 1 [M]).
FULL_HEIGHT, FULL_WIDTH = 900, 1600
MODEL_HEIGHT, MODEL_WIDTH = 450, 800


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Static shape/config info shared by datagen, loaders, and jitted preproc."""

    height: int = MODEL_HEIGHT
    width: int = MODEL_WIDTH
    num_sweeps: int = DEFAULT_NUM_SWEEPS
    radar_points_per_sweep: int = MAX_RADAR_POINTS_PER_SWEEP
    lidar_points: int = MAX_LIDAR_POINTS
    min_depth: float = 0.0
    max_depth: float = 80.0

    @property
    def radar_points_total(self) -> int:
        return self.num_sweeps * self.radar_points_per_sweep


# A Sample is a dict of numpy arrays with these keys/shapes (H0/W0 = model
# working resolution; S = num_sweeps; Pr = radar_points_per_sweep;
# Pl = lidar_points):
#
#   image            uint8   (H0, W0, 3)   RGB frame (already at model res)
#   lidar_depth      float32 (H0, W0)      GT depth map, 0 = invalid
#   lidar_points     float32 (Pl, 3)       cam-frame LiDAR points
#   lidar_valid      bool    (Pl,)
#   radar_points     float32 (S, Pr, 3)    sensor-frame radar points per sweep
#   radar_valid      bool    (S, Pr)
#   radar_transform  float32 (S, 4, 4)     cam←sensor chain per sweep
#   intrinsics       float32 (3, 3)        K at model working resolution
#
# A Batch is the same with a leading batch axis on every array.
Sample = Dict[str, np.ndarray]
Batch = Dict[str, Any]

SAMPLE_KEYS = (
    "image",
    "lidar_depth",
    "lidar_points",
    "lidar_valid",
    "radar_points",
    "radar_valid",
    "radar_transform",
    "intrinsics",
)


def sample_shapes(spec: SampleSpec) -> Dict[str, tuple]:
    h, w = spec.height, spec.width
    s, pr, pl = spec.num_sweeps, spec.radar_points_per_sweep, spec.lidar_points
    return {
        "image": (h, w, 3),
        "lidar_depth": (h, w),
        "lidar_points": (pl, 3),
        "lidar_valid": (pl,),
        "radar_points": (s, pr, 3),
        "radar_valid": (s, pr),
        "radar_transform": (s, 4, 4),
        "intrinsics": (3, 3),
    }


def sample_dtypes() -> Dict[str, np.dtype]:
    return {
        "image": np.dtype(np.uint8),
        "lidar_depth": np.dtype(np.float32),
        "lidar_points": np.dtype(np.float32),
        "lidar_valid": np.dtype(np.bool_),
        "radar_points": np.dtype(np.float32),
        "radar_valid": np.dtype(np.bool_),
        "radar_transform": np.dtype(np.float32),
        "intrinsics": np.dtype(np.float32),
    }


def validate_sample(sample: Sample, spec: SampleSpec) -> None:
    shapes = sample_shapes(spec)
    dtypes = sample_dtypes()
    for key in SAMPLE_KEYS:
        if key not in sample:
            raise KeyError(f"sample missing key {key!r}")
        arr = sample[key]
        if tuple(arr.shape) != shapes[key]:
            raise ValueError(f"{key}: shape {arr.shape} != {shapes[key]}")
        if arr.dtype != dtypes[key]:
            raise ValueError(f"{key}: dtype {arr.dtype} != {dtypes[key]}")


def stack_samples(samples: list) -> Batch:
    """Collate fixed-shape samples into a batch (trivial np.stack per key)."""
    return {k: np.stack([s[k] for s in samples], axis=0) for k in SAMPLE_KEYS}


def pad_points(points: np.ndarray, max_points: int) -> tuple:
    """Pad an (N, D) point array to (max_points, D) + bool mask. Truncates and
    warns via return count if N > max_points — callers should log drops
    (SURVEY.md §7 hard part #2: no silent truncation)."""
    n = points.shape[0]
    kept = min(n, max_points)
    out = np.zeros((max_points,) + points.shape[1:], dtype=np.float32)
    out[:kept] = points[:kept]
    mask = np.zeros((max_points,), dtype=bool)
    mask[:kept] = True
    return out, mask, n - kept
