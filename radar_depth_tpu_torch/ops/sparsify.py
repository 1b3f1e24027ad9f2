"""Dense -> sparse depth samplers, mirroring ``radar_depth_tpu/ops/
sparsify.py`` (the reference's ``--sparsifier`` / ``--num-samples``): the
sparse channel is sampled from the LiDAR depth instead of the radar.

Each pixel is kept with a probability p by comparing a uniform draw in
[0, 1) with p, so the number kept is binomial around ``num_samples``. The
draws ``u`` (B, H, W) float32 are an argument: ``jax.random`` streams cannot
be reproduced in torch, so a test passes JAX's own draws and gets JAX's
bits; without ``u`` they come from ``generator`` (``torch.rand``, on the
depth's device).
"""

from __future__ import annotations

import torch


def draw_uniform(depth: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of ``depth``'s shape and device."""
    return torch.rand(depth.shape, generator=generator, device=depth.device,
                      dtype=torch.float32)


def _keep_prob(mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    """p = min(1, num_samples / max(count, 1)) per sample, in float32."""
    n = mask.sum(dim=(-2, -1), keepdim=True).to(torch.float32)
    return torch.clamp(_scalar(num_samples, n) / n.clamp_min(1.0), max=1.0)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device. Divisions here
    take tensors on both sides: torch computes ``number / x`` as
    ``reciprocal(x) * number``, and CUDA ``x / number`` as ``x *
    (1/number)``, each an ulp off the quotient in places."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def uniform_sampling(depth: torch.Tensor, num_samples: int,
                     u: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """Keep each valid (> 0) pixel of (B, H, W) ``depth`` with p =
    num_samples / n_valid."""
    valid = depth > 0
    if u is None:
        u = draw_uniform(depth, generator)
    keep = u < _keep_prob(valid, num_samples)
    return torch.where(valid & keep, depth, torch.zeros_like(depth))


def simulated_stereo(depth: torch.Tensor, num_samples: int,
                     u: torch.Tensor | None = None,
                     generator: torch.Generator | None = None,
                     max_depth: float = 80.0, min_depth: float = 1.0
                     ) -> torch.Tensor:
    """Quantize inverse depth into 64 bands over [1/max_depth,
    1/min_depth] (depths outside clamp to the end bands) and keep the valid
    pixels whose band differs from the pixel above or to the left (with
    wrap-around, as ``jnp.roll``), each with p = num_samples / n_candidates:
    a stereo matcher's density at disparity steps."""
    valid = depth > 0
    safe = torch.where(valid, depth, torch.full_like(depth, max_depth))
    inv = _scalar(1.0, safe) / safe.clamp_min(1e-3)
    inv_min = 1.0 / max_depth
    inv_max = 1.0 / max(min_depth, 1e-3)
    n_levels = 64
    band = torch.floor((inv - inv_min) / _scalar(inv_max - inv_min + 1e-6, inv)
                       * n_levels)
    band = band.clamp(0, n_levels - 1)
    down = torch.roll(band, 1, dims=-2)
    right = torch.roll(band, 1, dims=-1)
    candidates = valid & ((band != down) | (band != right))
    if u is None:
        u = draw_uniform(depth, generator)
    keep = u < _keep_prob(candidates, num_samples)
    return torch.where(candidates & keep, depth, torch.zeros_like(depth))


SPARSIFIERS = {"uar": uniform_sampling, "sim_stereo": simulated_stereo}
