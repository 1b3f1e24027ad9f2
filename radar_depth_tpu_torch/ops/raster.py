"""Sparse-depth rasterization and multi-sweep accumulation on tensors.

Mirrors ``radar_depth_tpu/ops/raster.py``, ``radar_to_depth_map`` and
``depth_map_to_points`` included: points ride in fixed-size padded
buffers with validity masks; ``bin_points`` is the one binning rule (int32
floor, half-open image bounds, open depth range). Two z-buffer backends
follow it, as in the JAX package: "sorted" (``sort_points_by_pixel``, then
kernel C, ``ops/kernels.py::zbuffer_min_depth_sorted``) and "scatter"
(kernel A, ``ops/kernels.py::zbuffer_min_depth``). min is order-free, so both
give the bits of a sequential loop whatever order the points are reduced in.
"""

from __future__ import annotations

import torch

from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.geometry import project_points, se3_apply


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
    # Python scalars, not tensors built on the host: a host-to-device copy
    # of a scalar would wait for the stream.
    ui = torch.where(ok, u, 0.0).to(torch.int32)
    vi = torch.where(ok, v, 0.0).to(torch.int32)
    lin = torch.where(ok, vi * width + ui, invalid_lin).to(torch.int32)
    zf = torch.where(ok, z, float("inf"))
    return lin, zf.to(torch.float32), ok


RASTER_BACKENDS = ("sorted", "scatter")


def sort_points_by_pixel(uv: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                         height: int, width: int, min_depth: float,
                         max_depth: float):
    """Front half of the sorted backend: ``bin_points`` with dropped points
    at the sentinel 2**30, then a stable sort of each row by pixel index and
    the same permutation of the depths. Returns (lin_sorted, z_sorted), each
    (..., P); within a pixel's run the depths keep their input order, as
    JAX's ``sort_key_val`` leaves them."""
    lin, zf, _ = bin_points(uv, z, valid, height, width, min_depth, max_depth,
                            invalid_lin=kernels.SORTED_INVALID)
    lin_sorted, order = torch.sort(lin, dim=-1, stable=True)
    return lin_sorted, torch.gather(zf, -1, order)


def rasterize_min_depth(uv: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                        height: int, width: int, min_depth: float = 0.0,
                        max_depth: float = float("inf"),
                        backend: str = "sorted",
                        plain: bool = False) -> torch.Tensor:
    """(..., P, 2) pixel coords, (..., P) depths and masks -> (..., H, W)
    float32 map of the minimum depth per pixel, 0 where no point lands.

    ``backend="sorted"`` sorts the points by pixel and runs kernel C;
    ``"scatter"`` runs kernel A on the points as they come. Both kernels
    reduce on the int32 bit pattern of the depth, which orders like the
    float only for non-negative depths, so ``min_depth`` must be >= 0
    (``bin_points`` keeps only ``z > min_depth``). ``plain=True`` runs the
    kernel's plain PyTorch version on any device (the reference on the card).
    """
    if backend not in RASTER_BACKENDS:
        raise ValueError(f"raster backend {backend!r}: expected one of "
                         f"{RASTER_BACKENDS}")
    if min_depth < 0:
        raise ValueError(
            f"min_depth={min_depth}: the z-buffer orders depths by their "
            "int32 bits, which needs non-negative depths")
    lead = uv.shape[:-2]
    p = uv.shape[-2]
    args = (uv.reshape(-1, p, 2), z.reshape(-1, p), valid.reshape(-1, p),
            height, width, min_depth, max_depth)
    if backend == "sorted":
        lin, zf = sort_points_by_pixel(*args)
        fn = (kernels.zbuffer_min_depth_sorted_reference if plain
              else kernels.zbuffer_min_depth_sorted)
    else:
        lin, zf, _ = bin_points(*args, invalid_lin=-1)
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


def radar_to_depth_map(sweep_points: torch.Tensor, sweep_valid: torch.Tensor,
                       T_cam_from_sensor: torch.Tensor, K: torch.Tensor,
                       height: int, width: int, min_depth: float = 0.0,
                       max_depth: float = 100.0, height_extension: int = 0,
                       backend: str = "sorted",
                       plain: bool = False) -> torch.Tensor:
    """Multi-sweep radar -> sparse depth map, the JAX package's function
    with its defaults: ``accumulate_sweeps``, ``project_points``, with
    ``height_extension`` > 0 ``extend_height`` by ``-he..he`` rows, then
    ``rasterize_min_depth`` (``backend`` and ``plain`` passed on: kernel C
    or kernel A on the card, their plain versions on the CPU).

    (..., S, P, 3) sensor-frame points, (..., S, P) masks, (..., S, 4, 4)
    cam<-sensor chains and (..., 3, 3) intrinsics -> (..., height, width)
    float32."""
    pts_cam, valid = accumulate_sweeps(sweep_points, sweep_valid,
                                       T_cam_from_sensor)
    uv, z = project_points(pts_cam, K)
    if height_extension > 0:
        offsets = torch.arange(-height_extension, height_extension + 1,
                               device=uv.device)
        uv, z, valid = extend_height(uv, z, valid, offsets)
    return rasterize_min_depth(uv, z, valid, height, width,
                               min_depth=min_depth, max_depth=max_depth,
                               backend=backend, plain=plain)


def depth_map_to_points(depth: torch.Tensor, max_points: int):
    """Inverse of rasterization: up to ``max_points`` (u, v) pixel
    coordinates and depths of the set (> 0) pixels of (..., H, W) maps,
    padded and masked: (..., N, 2) float32 uv, (..., N) z and (..., N) bool
    valid. The set pixels come first in row-major order, then the padding:
    the unset pixels, also in row-major order. That is the order of JAX's
    ``lax.top_k`` over the 0/1 score, which keeps the lower index first
    among equal scores; a stable descending sort gives it (``torch.topk``
    does not promise an order among ties)."""
    h, w = depth.shape[-2], depth.shape[-1]
    if max_points > h * w:
        raise ValueError(f"max_points={max_points} > the {h}x{w} map's "
                         f"{h * w} pixels")
    flat = depth.reshape(depth.shape[:-2] + (h * w,))
    score = (flat > 0).to(torch.float32)
    idx = torch.sort(score, dim=-1, descending=True,
                     stable=True).indices[..., :max_points]
    z = torch.gather(flat, -1, idx)
    uv = torch.stack([(idx % w).to(torch.float32),
                      (idx // w).to(torch.float32)], dim=-1)
    return uv, z, z > 0
