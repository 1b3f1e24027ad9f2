"""Sparse-depth rasterization and multi-sweep accumulation on tensors.

Mirrors ``radar_depth_tpu/ops/raster.py``: points ride in fixed-size padded
buffers with validity masks; ``bin_points`` is the one binning rule (int32
floor, half-open image bounds, open depth range) and the min-depth z-buffer
behind it is kernel A (``ops/kernels.py::zbuffer_min_depth``). min is
order-free, so the map is bit-identical to a sequential loop whatever order
the points are reduced in.
"""

from __future__ import annotations

import torch

from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.geometry import se3_apply


def bin_points(uv: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
               height: int, width: int, min_depth: float, max_depth: float,
               invalid_lin: int):
    """Floor-bin + bounds/depth-range filter.

    Returns (lin, zf, ok): int32 linear pixel index ``v*width + u`` with
    ``invalid_lin`` for dropped points, float32 depth with +inf for dropped
    points, and the keep mask. The bounds are tested on the floored floats,
    before the int32 cast, so out-of-range, infinite and NaN coordinates are
    dropped the same way on every device (a float->int cast of them is
    undefined in C++); for in-range values the test equals the JAX package's
    integer test.
    """
    u = torch.floor(uv[..., 0])
    v = torch.floor(uv[..., 1])
    ok = (valid & (u >= 0) & (u < width) & (v >= 0) & (v < height)
          & (z > min_depth) & (z < max_depth))
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    ui = torch.where(ok, u, zero).to(torch.int32)
    vi = torch.where(ok, v, zero).to(torch.int32)
    lin = torch.where(ok, vi * width + ui,
                      torch.tensor(invalid_lin, dtype=torch.int32,
                                   device=u.device))
    zf = torch.where(ok, z, torch.tensor(float("inf"), device=z.device))
    return lin, zf.to(torch.float32), ok


def rasterize_min_depth(uv: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                        height: int, width: int, min_depth: float = 0.0,
                        max_depth: float = float("inf"),
                        plain: bool = False) -> torch.Tensor:
    """(..., P, 2) pixel coords, (..., P) depths and masks -> (..., H, W)
    float32 map of the minimum depth per pixel, 0 where no point lands.

    Kernel A reduces on the int32 bit pattern of the depth, which orders like
    the float only for non-negative depths, so ``min_depth`` must be >= 0
    (``bin_points`` keeps only ``z > min_depth``). ``plain=True`` runs the
    kernel's plain PyTorch version on any device (the reference on the card).
    """
    if min_depth < 0:
        raise ValueError(
            f"min_depth={min_depth}: the z-buffer orders depths by their "
            "int32 bits, which needs non-negative depths")
    lead = uv.shape[:-2]
    p = uv.shape[-2]
    lin, zf, _ = bin_points(uv.reshape(-1, p, 2), z.reshape(-1, p),
                            valid.reshape(-1, p), height, width, min_depth,
                            max_depth, invalid_lin=-1)
    fn = (kernels.zbuffer_min_depth_reference if plain
          else kernels.zbuffer_min_depth)
    out = fn(lin.contiguous(), zf.contiguous(), height, width)
    return out.reshape(lead + (height, width))


def accumulate_sweeps(sweep_points: torch.Tensor, sweep_valid: torch.Tensor,
                      T_cam_from_sensor: torch.Tensor):
    """Merge S sweeps into one camera-frame buffer: (..., S, P, 3) points,
    (..., S, P) masks, (..., S, 4, 4) cam<-sensor chains -> (..., S*P, 3)
    points and (..., S*P) masks."""
    pts_cam = se3_apply(T_cam_from_sensor, sweep_points)
    batch = sweep_points.shape[:-3]
    s, p = sweep_points.shape[-3], sweep_points.shape[-2]
    return (pts_cam.reshape(batch + (s * p, 3)),
            sweep_valid.reshape(batch + (s * p,)))


def extend_height(uv: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                  offsets: torch.Tensor):
    """Replicate each projected return once per row offset in ``offsets``
    (J,), shifting v: the point axis grows from P to P*J."""
    j = offsets.shape[0]
    delta = torch.stack([torch.zeros_like(offsets), offsets], dim=-1)
    uv_ext = uv[..., None, :] + delta.to(uv.dtype)
    lead, p = uv.shape[:-2], uv.shape[-2]
    return (uv_ext.reshape(lead + (p * j, 2)),
            z[..., None].expand(z.shape + (j,)).reshape(lead + (p * j,)),
            valid[..., None].expand(valid.shape + (j,)).reshape(lead + (p * j,)))
