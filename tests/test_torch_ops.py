"""The port's kernels as registered torch operators (torch.ops.rdt.*,
radar_depth_tpu_torch/ops/kernels.py) on the CPU: torch.library.opcheck on
each (schema, fake implementation, tracing), each operator equal to its
plain version and to the JAX package's Pallas kernel in interpret mode on
tests/test_torch_kernels.py's cases, and no implementation for a device
other than the CPU and the card.

The CUDA implementations are held to the same checks on the card by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.ops.pallas_kernels import (
    fused_scale_bias_relu,
    rasterize_min_depth_pallas,
    rasterize_min_depth_pallas_sorted,
)
from radar_depth_tpu_torch.ops import kernels
from tests.test_torch_gpu import (
    ZBUFFER_EDGE_CASES,
    sort_by_pixel,
    zbuffer_edge_case,
)

OPS = torch.ops.rdt


def epilogue_case(dtype, residual, layout="nchw", seed=3):
    """(x, scale, bias, residual) as kernel B takes them: NCHW in
    channels_last memory (the model's layout) or a contiguous (..., C)."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, 32, 8, 16) if layout == "nchw" else (256, 32)
    fmt = (torch.channels_last if layout == "nchw"
           else torch.contiguous_format)
    mk = lambda: torch.randn(shape, generator=g).to(dtype, memory_format=fmt)
    return (mk(), torch.rand(32, generator=g) + 0.5,
            torch.randn(32, generator=g) * 0.1, mk() if residual else None)


EPILOGUE_CASES = [(torch.float32, False, "nchw"), (torch.float32, True, "nchw"),
                  (torch.bfloat16, False, "nchw"),
                  (torch.bfloat16, True, "nchw"), (torch.float32, True, "nc")]


@pytest.mark.parametrize("dtype,residual,layout", EPILOGUE_CASES,
                         ids=["f32", "f32_res", "bf16", "bf16_res",
                              "f32_res_flat"])
def test_opcheck_scale_bias_relu(dtype, residual, layout):
    args = epilogue_case(dtype, residual, layout)
    torch.library.opcheck(OPS.scale_bias_relu.default, args)
    out = OPS.scale_bias_relu(*args)
    assert out.stride() == args[0].stride()  # channels_last kept


@pytest.mark.parametrize("case", ["tile_edges", "empty_row_beside_full_row"])
def test_opcheck_zbuffers(case):
    lin, z, h, w = zbuffer_edge_case(case)
    lin_s, z_s = sort_by_pixel(lin, z)
    torch.library.opcheck(OPS.zbuffer_min_depth.default,
                          (torch.from_numpy(lin), torch.from_numpy(z), h, w))
    torch.library.opcheck(OPS.zbuffer_min_depth_sorted.default,
                          (torch.from_numpy(lin_s), torch.from_numpy(z_s), h,
                           w))


@pytest.mark.parametrize("case", ZBUFFER_EDGE_CASES)
def test_zbuffer_ops_match_plain_and_pallas(case):
    """Both z-buffer operators bit-exact against their plain versions and
    against both Pallas kernels in interpret mode."""
    lin, z, h, w = zbuffer_edge_case(case)
    lin_s, z_s = sort_by_pixel(lin, z)
    bits = lambda a: np.asarray(a, np.float32).view(np.int32)
    want = np.asarray(rasterize_min_depth_pallas(
        jnp.asarray(lin), jnp.asarray(z), h, w, interpret=True))
    want_sorted = np.asarray(rasterize_min_depth_pallas_sorted(
        jnp.asarray(lin_s), jnp.asarray(z_s), h, w, interpret=True))
    t = torch.from_numpy
    got_a = OPS.zbuffer_min_depth(t(lin), t(z), h, w)
    got_c = OPS.zbuffer_min_depth_sorted(t(lin_s), t(z_s), h, w)
    np.testing.assert_array_equal(
        bits(got_a), bits(kernels.zbuffer_min_depth_reference(t(lin), t(z),
                                                              h, w)))
    np.testing.assert_array_equal(
        bits(got_c), bits(kernels.zbuffer_min_depth_sorted_reference(
            t(lin_s), t(z_s), h, w)))
    np.testing.assert_array_equal(bits(got_a), bits(want))
    np.testing.assert_array_equal(bits(got_c), bits(want_sorted))


@pytest.mark.parametrize("with_residual", [False, True])
def test_epilogue_op_matches_plain_and_pallas(with_residual):
    """float32 operator against its plain version (bit-exact) and the Pallas
    kernel in interpret mode (within 1e-6, as test_torch_kernels.py)."""
    x, scale, bias, res = epilogue_case(torch.float32, with_residual)
    got = OPS.scale_bias_relu(x, scale, bias, res)
    assert torch.equal(got, kernels.scale_bias_relu_reference(x, scale, bias,
                                                              res))
    nhwc = lambda a: jnp.asarray(a.permute(0, 2, 3, 1).numpy())
    want = np.asarray(fused_scale_bias_relu(
        nhwc(x), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()),
        None if res is None else nhwc(res), interpret=True))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)


def test_wrappers_call_the_ops_and_refuse_other_devices():
    """The wrappers give the operators' results on the CPU and launch
    nothing there; a tensor on the meta device makes a wrapper raise, and
    the operator itself gives only the fake implementation's empty output
    (its shape, dtype and memory format), never the plain version's."""
    kernels.scale_bias_relu.launches = 0
    x, scale, bias, res = epilogue_case(torch.bfloat16, True)
    assert torch.equal(kernels.scale_bias_relu(x, scale, bias, res),
                       OPS.scale_bias_relu(x, scale, bias, res))
    assert kernels.scale_bias_relu.launches == 0
    meta = [None if a is None else a.to("meta") for a in (x, scale, bias, res)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernels.scale_bias_relu(*meta)
    out = OPS.scale_bias_relu(*meta)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert out.shape == x.shape and out.stride() == x.stride()
    lin, z, h, w = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in zbuffer_edge_case("b1_p1"))
    for wrapper in (kernels.zbuffer_min_depth,
                    kernels.zbuffer_min_depth_sorted):
        with pytest.raises(ValueError, match="unsupported device meta"):
            wrapper(lin.to("meta"), z.to("meta"), h, w)
    out = OPS.zbuffer_min_depth(lin.to("meta"), z.to("meta"), h, w)
    assert out.device.type == "meta" and out.shape == (1, h, w)
