"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; each test skips without a CUDA device (the kernels have no CPU
build). This file imports no JAX, so it also runs where only the port is
installed:  python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.raster import bin_points, sort_points_by_pixel


def _random_points(b, p, h, w, seed):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-5, w * 1.4, size=(b, p)),
                   rng.uniform(-5, h * 1.4, size=(b, p))],
                  axis=-1).astype(np.float32)
    z = rng.uniform(-2, 90, size=(b, p)).astype(np.float32)
    valid = rng.uniform(size=(b, p)) > 0.15
    return uv, z, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions_on_card(dtype):
    """Both CUDA kernels against their plain versions on the card: the
    z-buffer bit-exact, the epilogue bit-exact too (the kernel rounds in the
    plain version's order, without fused multiply-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    uv, z, valid = _random_points(4, 640, 90, 160, seed=1)
    lin, zf, _ = bin_points(torch.from_numpy(uv).to(dev),
                            torch.from_numpy(z).to(dev),
                            torch.from_numpy(valid).to(dev), 90, 160, 0.0,
                            80.0, -1)
    got = kernels.zbuffer_min_depth(lin, zf, 90, 160)
    assert torch.equal(got, kernels.zbuffer_min_depth_reference(lin, zf, 90,
                                                                160))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 64, 30, 50, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last)
    r = torch.randn(2, 64, 30, 50, generator=g, device=dev).to(
        dtype, memory_format=torch.channels_last)
    s = torch.randn(64, generator=g, device=dev)
    b = torch.randn(64, generator=g, device=dev)
    for res in (None, r):
        assert torch.equal(kernels.scale_bias_relu(x, s, b, res),
                           kernels.scale_bias_relu_reference(x, s, b, res))


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(4, 640), (2, 40960), (3, 641)])
def test_sorted_zbuffer_matches_plain_and_kernel_a_on_card(b, p):
    """Kernel C against its plain version and against kernel A on the same
    points, bit-exact, twice (the map does not depend on the order in which
    the atomics land); P=641 is not a multiple of the block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    dev = torch.device("cuda")
    h, w = 90, 160
    uv, z, valid = (torch.from_numpy(a).to(dev)
                    for a in _random_points(b, p, h, w, seed=p))
    lin, zs = sort_points_by_pixel(uv, z, valid, h, w, 0.0, 80.0)
    got = kernels.zbuffer_min_depth_sorted(lin, zs, h, w)
    assert torch.equal(got, kernels.zbuffer_min_depth_sorted(lin, zs, h, w))
    assert torch.equal(got, kernels.zbuffer_min_depth_sorted_reference(
        lin, zs, h, w))
    lin_a, zf_a, _ = bin_points(uv, z, valid, h, w, 0.0, 80.0, -1)
    assert torch.equal(got, kernels.zbuffer_min_depth(lin_a, zf_a, h, w))
