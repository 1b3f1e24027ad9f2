"""The port's kernels (radar_depth_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels, which run here in interpret mode.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions by tests/test_torch_gpu.py
(skipped without a card) and by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radar_depth_tpu.ops import rasterize_min_depth as jax_rasterize
from radar_depth_tpu.ops.pallas_kernels import (
    fused_scale_bias_relu,
    points_to_linear,
    rasterize_min_depth_pallas,
)
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.raster import bin_points, rasterize_min_depth


def _random_points(b, p, h, w, seed):
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.uniform(-5, w * 1.4, size=(b, p)),
                   rng.uniform(-5, h * 1.4, size=(b, p))],
                  axis=-1).astype(np.float32)
    z = rng.uniform(-2, 90, size=(b, p)).astype(np.float32)
    valid = rng.uniform(size=(b, p)) > 0.15
    return uv, z, valid


@pytest.mark.parametrize("b,p,h,w", [(3, 700, 40, 64), (2, 130, 37, 61)])
def test_zbuffer_matches_pallas_and_xla(b, p, h, w):
    """Binning and z-buffer bit-exact against the Pallas kernel (interpret
    mode) and the XLA scatter path; P=130 is a ragged tail."""
    uv, z, valid = _random_points(b, p, h, w, seed=p)
    lin_j, zf_j = points_to_linear(jnp.asarray(uv), jnp.asarray(z),
                                   jnp.asarray(valid), h, w, 0.0, 80.0)
    lin, zf, _ = bin_points(torch.from_numpy(uv), torch.from_numpy(z),
                            torch.from_numpy(valid), h, w, 0.0, 80.0, -1)
    np.testing.assert_array_equal(lin.numpy(), np.asarray(lin_j))
    np.testing.assert_array_equal(zf.numpy(), np.asarray(zf_j))

    got = kernels.zbuffer_min_depth_reference(lin, zf, h, w).numpy()
    want_pallas = np.asarray(rasterize_min_depth_pallas(lin_j, zf_j, h, w,
                                                        interpret=True))
    want_xla = np.asarray(jax_rasterize(jnp.asarray(uv), jnp.asarray(z),
                                        jnp.asarray(valid), h, w,
                                        min_depth=0.0, max_depth=80.0))
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    full = rasterize_min_depth(torch.from_numpy(uv), torch.from_numpy(z),
                               torch.from_numpy(valid), h, w, 0.0, 80.0)
    np.testing.assert_array_equal(full.numpy(), want_xla)


def test_zbuffer_empty_and_duplicates():
    """Invalid points, duplicates resolving to the minimum, the last pixel."""
    h, w = 16, 32
    lin = np.asarray([[-1, -1, 5, 5, 5, 511]], np.int32)
    z = np.asarray([[np.inf, np.inf, 3.0, 1.5, 9.0, 2.0]], np.float32)
    got = kernels.zbuffer_min_depth_reference(torch.from_numpy(lin),
                                              torch.from_numpy(z), h, w)
    want = np.asarray(rasterize_min_depth_pallas(jnp.asarray(lin),
                                                 jnp.asarray(z), h, w,
                                                 interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 5] == 1.5 and got[0, 511 // w, 511 % w] == 2.0
    assert got.sum() == 1.5 + 2.0


def test_zbuffer_all_invalid_and_one_pixel():
    """An all-invalid batch element, and one where every point lands in the
    same pixel (the longest possible run)."""
    h, w, p = 16, 32, 256
    uv = np.zeros((2, p, 2), np.float32)
    uv[1, :, 0], uv[1, :, 1] = 7.3, 2.9
    z = np.full((2, p), 5.0, np.float32)
    z[1] = np.linspace(80, 1, p)
    valid = np.zeros((2, p), bool)
    valid[1] = True
    got = rasterize_min_depth(torch.from_numpy(uv), torch.from_numpy(z),
                              torch.from_numpy(valid), h, w, 0.0, 100.0)
    lin_j, zf_j = points_to_linear(jnp.asarray(uv), jnp.asarray(z),
                                   jnp.asarray(valid), h, w, 0.0, 100.0)
    want = np.asarray(rasterize_min_depth_pallas(lin_j, zf_j, h, w,
                                                 interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].sum() == 0.0
    assert got[1, 2, 7] == np.float32(1.0) and got[1].sum() == np.float32(1.0)


def test_zbuffer_rejects_negative_min_depth():
    uv = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="non-negative"):
        rasterize_min_depth(uv, torch.ones(1, 4), torch.ones(1, 4, dtype=bool),
                            4, 4, min_depth=-1.0)


@pytest.mark.parametrize("with_residual", [False, True])
def test_epilogue_matches_pallas(with_residual):
    """fp32 plain epilogue against the Pallas kernel in interpret mode,
    within 1e-6 (the same float32 multiply and adds)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32) if with_residual else None
    want = np.asarray(fused_scale_bias_relu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        None if res is None else jnp.asarray(res), interpret=True))
    # NHWC memory seen as NCHW channels_last, as the port's convs produce it
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    got = kernels.scale_bias_relu_reference(
        nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
        None if res is None else nchw(res))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)
    flat = kernels.scale_bias_relu_reference(
        torch.from_numpy(x).reshape(-1, 32), torch.from_numpy(scale),
        torch.from_numpy(bias),
        None if res is None else torch.from_numpy(res).reshape(-1, 32))
    np.testing.assert_allclose(flat.reshape(x.shape).numpy(), want,
                               atol=1e-6, rtol=0)


def test_wrappers_run_plain_version_on_cpu():
    """Given CPU tensors, the wrappers return their plain versions' result
    and launch nothing (the counters do not move)."""
    kernels.zbuffer_min_depth.launches = 0
    kernels.scale_bias_relu.launches = 0
    lin = torch.tensor([[3, -1, 3, 7]], dtype=torch.int32)
    z = torch.tensor([[4.0, 1.0, 2.0, 6.0]])
    got = kernels.zbuffer_min_depth(lin, z, 2, 4)
    assert torch.equal(got, kernels.zbuffer_min_depth_reference(lin, z, 2, 4))
    x = torch.randn(2, 8, 3, 5).to(memory_format=torch.channels_last)
    s, b = torch.randn(8), torch.randn(8)
    assert torch.equal(kernels.scale_bias_relu(x, s, b, x),
                       kernels.scale_bias_relu_reference(x, s, b, x))
    assert kernels.zbuffer_min_depth.launches == 0
    assert kernels.scale_bias_relu.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    s, b = torch.randn(8), torch.randn(8)
    with pytest.raises(ValueError, match="channels_last"):
        kernels.scale_bias_relu(torch.randn(2, 8, 3, 5), s, b)
    x = torch.randn(2, 8, 3, 5).to(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="scale"):
        kernels.scale_bias_relu(x, torch.randn(4), b)
    with pytest.raises(TypeError):
        kernels.scale_bias_relu(x.half(), s, b)
    with pytest.raises(TypeError):
        kernels.zbuffer_min_depth(torch.zeros(1, 4, dtype=torch.int64),
                                  torch.zeros(1, 4), 2, 2)
