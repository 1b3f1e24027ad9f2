"""Train-time augmentation on tensors: random scale, rotation, horizontal
flip and color jitter, with depth values divided by the scale factor.

Mirrors ``radar_depth_tpu/ops/augment.py``. Each sample gets one 2x3
raster-space affine A = F.T(c).R(theta).S(s).T(-c) (rotate and scale about
the image center, then an optional flip). The image is warped once by
bilinear gather; sparse depth is never interpolated: projected points are
pushed through A and rasterized again, or the stored map is warped with
nearest sampling (``warp_depths_nearest``).

Randomness comes from an explicit ``torch.Generator``. Its streams differ
from ``jax.random``'s, so the tests draw the parameters with the JAX package
and hand them to ``make_affine`` here.

Rounding. Every product that decides a pixel bin is rounded as the JAX
package's jitted train step rounds it on the CPU, so the warped maps come
out bit-identical to it: ``apply_affine_uv`` is the 2-term fused
multiply-add chain of XLA's CPU dot (``ops/geometry.py::_dot``), and where
XLA's CPU compiler contracts a product into the add that follows it
(``make_affine``, ``invert_affine``, ``_src_coords``) the port computes the
same fused multiply-add (``_fma``). The same code runs on the card, so the
bins do not depend on the device. cos and sin are taken in float64 and
rounded once, for the same reason; XLA's float32 sin (glibc's ``sinf``)
differs from that by one ulp for a few angles in a thousand.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from radar_depth_tpu_torch.ops.geometry import _dot


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The reference train_transform's knobs (the JAX ``AugmentConfig``)."""

    scale_range: Tuple[float, float] = (1.0, 1.5)
    rotation_deg: float = 5.0
    hflip_prob: float = 0.5
    jitter: float = 0.4  # brightness/contrast/saturation multiplier range
    enabled: bool = True


def sample_affine_params(generator: torch.Generator, cfg: AugmentConfig,
                         batch: int):
    """Per-sample augmentation parameters drawn from ``generator``, on its
    device: (scale (B,), angle (B,) radians, flip (B,) bool, jitter (B, 3))."""
    dev = generator.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + (hi - lo) * u

    rot = cfg.rotation_deg * math.pi / 180
    scale = uniform((batch,), *cfg.scale_range)
    angle = uniform((batch,), -rot, rot)
    flip = torch.rand((batch,), generator=generator, device=dev) < cfg.hflip_prob
    jitter = uniform((batch, 3), 1.0 - cfg.jitter, 1.0 + cfg.jitter)
    return scale, angle, flip, jitter


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add x*y + z, rounded once: the float64 product
    of float32 values is exact."""
    return (x.double() * y.double() + z.double()).float()


def make_affine(scale: torch.Tensor, angle: torch.Tensor, flip: torch.Tensor,
                height: int, width: int) -> torch.Tensor:
    """Forward raster-space affine (..., 2, 3): uv_out = A @ [u, v, 1].

    Raster coordinates: pixel bin j covers [j, j+1), so the image center is
    (W/2, H/2) and a bin-exact horizontal flip is u -> W - u."""
    cx, cy = width / 2.0, height / 2.0
    c = torch.cos(angle.double()).float() * scale
    s = torch.sin(angle.double()).float() * scale
    # cx - c*cx + s*cy and cy - s*cx - c*cy, each product fused into the add
    # that follows it
    cxs, cys = torch.full_like(c, cx), torch.full_like(c, cy)
    a02 = _fma(s, cys, _fma(-c, cxs, cxs))
    a12 = _fma(-c, cys, _fma(-s, cxs, cys))
    sign = torch.where(flip, -1.0, 1.0)
    off = torch.where(flip, float(width), 0.0)
    row0 = torch.stack([sign * c, sign * (-s), sign * a02 + off], dim=-1)
    row1 = torch.stack([s, c, a12], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def invert_affine(A: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affines analytically. The products that feed an
    add are fused (``det = fma(a, d, -b*c)``, ``itx = -fma(ia, tx, ib*ty)``),
    as XLA's CPU compiler contracts them in the JAX package's jitted step."""
    a, b, tx = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    c, d, ty = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    det = _fma(a, d, -(b * c))
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -_fma(ia, tx, ib * ty)
    ity = -_fma(ic, tx, id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def apply_affine_uv(A: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Apply (..., 2, 3) affines to (..., P, 2) pixel coords."""
    lin = A[..., None, :, :2]  # (..., 1, 2, 2)
    rows = [_dot(lin[..., i, :], uv) for i in range(2)]
    return torch.stack(rows, dim=-1) + A[..., None, :, 2]


def _src_coords(A: torch.Tensor, h: int, w: int, half_pixel: bool):
    """Back-projected source coordinates (su, sv), each (B, H, W), of every
    output pixel under (B, 2, 3) forward affines. A lives in raster coords
    (bin centers at j+0.5); image sampling puts pixel centers at integers,
    hence the half-pixel shift when ``half_pixel``."""
    Ainv = invert_affine(A)[..., None, None]  # (B, 2, 3, 1, 1)
    vs, us = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=A.device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=A.device) + 0.5,
        indexing="ij")
    off = 0.5 if half_pixel else 0.0
    # fma(a, u, b*v) + c - off: the first product fused, as in the JAX step
    return tuple(_fma(Ainv[:, r, 0], us, Ainv[:, r, 1] * vs)
                 + Ainv[:, r, 2] - off for r in range(2))


def _gather_pixels(flat: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """flat (B, H*W, C); vi, ui (B, H, W) int -> (B, H*W, C), 0 out of
    bounds."""
    b, c = flat.shape[0], flat.shape[-1]
    ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    lin = vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
    vals = torch.gather(flat, 1, lin.reshape(b, h * w, 1).expand(b, h * w, c))
    return torch.where(ok.reshape(b, h * w, 1), vals,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def warp_images_bilinear(imgs: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) images by (B, 2, 3) forward affines with inverse
    bilinear sampling; out-of-bounds reads 0 (black border)."""
    b, h, w, c = imgs.shape
    su, sv = _src_coords(A, h, w, half_pixel=True)
    u0, v0 = torch.floor(su), torch.floor(sv)
    fu = (su - u0).reshape(b, h * w, 1)
    fv = (sv - v0).reshape(b, h * w, 1)
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)
    flat = imgs.reshape(b, h * w, c)
    p00 = _gather_pixels(flat, v0i, u0i, h, w)
    p01 = _gather_pixels(flat, v0i, u0i + 1, h, w)
    p10 = _gather_pixels(flat, v0i + 1, u0i, h, w)
    p11 = _gather_pixels(flat, v0i + 1, u0i + 1, h, w)
    out = (p00 * (1 - fu) * (1 - fv) + p01 * fu * (1 - fv)
           + p10 * (1 - fu) * fv + p11 * fu * fv)
    return out.reshape(b, h, w, c)


def warp_depths_nearest(depths: torch.Tensor, A: torch.Tensor,
                        scales: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W) depth maps by (B, 2, 3) forward affines with nearest
    sampling and divide the values by the zoom factor (the reference's
    transform semantics on depth images). Out-of-bounds reads 0."""
    b, h, w = depths.shape
    su, sv = _src_coords(A, h, w, half_pixel=False)
    ui = torch.floor(su).to(torch.int64)
    vi = torch.floor(sv).to(torch.int64)
    vals = _gather_pixels(depths.reshape(b, h * w, 1), vi, ui, h, w)
    return vals.reshape(b, h, w) / scales[:, None, None]


def color_jitter(img: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Multiplicative brightness/contrast/saturation jitter on (B, H, W, 3)
    images in [0, 1]; ``factors`` (B, 3) = (brightness, contrast,
    saturation)."""
    bright = factors[..., 0][..., None, None, None]
    contrast = factors[..., 1][..., None, None, None]
    sat = factors[..., 2][..., None, None, None]
    img = img * bright
    mean = img.mean(dim=(-3, -2, -1), keepdim=True)
    img = mean + (img - mean) * contrast
    gray = img.mean(dim=-1, keepdim=True)
    img = gray + (img - gray) * sat
    return img.clamp(0.0, 1.0)
