"""Kernel B with the BN fold inside it, ``torch.ops.rdt.batch_norm_relu``
(radar_depth_tpu_torch/ops/kernels.py), on the CPU at B=2, 64x96:
torch.library.opcheck (the CPU and fake implementations), the operator
bit-equal to the BN module's ``folded()`` followed by
``scale_bias_relu_reference``, within 1e-6 of flax's eval-mode BatchNorm
followed by the Pallas ``fused_scale_bias_relu`` in interpret mode (the
tolerance of tests/test_torch_ops.py: the same float32 operations, the
normalisation associated differently), and the flagship's eval forward
bit-equal between the kernel path and ``use_plain_kernels``.

The CUDA implementation is held to its plain version on the card by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.models.layers import make_norm as jax_make_norm
from radar_depth_tpu.ops.pallas_kernels import fused_scale_bias_relu
from radar_depth_tpu_torch.models import (
    BatchNorm,
    create_model,
    init_random,
    use_plain_kernels,
)
from radar_depth_tpu_torch.ops import kernels
from radar_depth_tpu_torch.ops.preprocess import pack_model_inputs

OPS = torch.ops.rdt
B, H, W, C = 2, 64, 96, 32
EPS = 1e-5


def bn_case(dtype, residual, layout="nchw", seed=5):
    """numpy-drawn (x, weight, bias, running_mean, running_var, residual):
    x NCHW in channels_last memory (the model's layout) or a contiguous
    (..., C); the BN's parameters as tests/test_torch_models.py draws them
    (weight and var in [0.5, 1.5), bias and mean N(0, 0.1))."""
    rng = np.random.default_rng(seed)
    nhwc = lambda: rng.normal(size=(B, H, W, C)).astype(np.float32)

    def act(a):
        t = torch.from_numpy(a).to(dtype)
        if layout == "nchw":
            return t.permute(0, 3, 1, 2)  # channels_last memory
        return t.reshape(B * H, W, C)

    x = act(nhwc())
    res = act(nhwc()) if residual else None
    weight, var = (torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(
        np.float32)) for _ in range(2))
    bias, mean = (torch.from_numpy((rng.normal(size=C) * 0.1).astype(
        np.float32)) for _ in range(2))
    return x, weight, bias, mean, var, res


def bn_module(weight, bias, mean, var):
    bn = BatchNorm(C, epsilon=EPS, device="cpu").eval()
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(v)
    return bn


CASES = [(dtype, residual, layout)
         for dtype in (torch.float32, torch.bfloat16)
         for residual in (False, True) for layout in ("nchw", "nc")]


@pytest.mark.parametrize("dtype,residual,layout", CASES, ids=[
    f"{'f32' if d == torch.float32 else 'bf16'}"
    f"{'_res' if r else ''}_{lay}" for d, r, lay in CASES])
def test_opcheck_batch_norm_relu(dtype, residual, layout):
    x, w, b, m, v, res = bn_case(dtype, residual, layout)
    torch.library.opcheck(OPS.batch_norm_relu.default,
                          (x, w, b, m, v, EPS, res))
    out = OPS.batch_norm_relu(x, w, b, m, v, EPS, res)
    assert out.dtype == dtype and out.stride() == x.stride()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_op_equals_folded_then_plain_epilogue(dtype, residual):
    """The CPU operator, its wrapper and the BN module's kernel path are
    bit-equal to the module's ``folded()`` followed by
    ``scale_bias_relu_reference`` (the plain path), and launch nothing."""
    x, w, b, m, v, res = bn_case(dtype, residual)
    bn = bn_module(w, b, m, v)
    want = kernels.scale_bias_relu_reference(x, *bn.folded(), res)
    kernels.scale_bias_relu.launches = 0
    got = OPS.batch_norm_relu(x, w, b, m, v, EPS, res)
    bits = lambda t: t.view(torch.int16 if dtype == torch.bfloat16
                            else torch.int32)
    assert torch.equal(bits(got), bits(want))
    assert torch.equal(bits(kernels.batch_norm_relu(x, w, b, m, v, EPS, res)),
                       bits(want))
    with torch.inference_mode():
        assert torch.equal(bits(bn(x, relu=True, residual=res)), bits(want))
    assert kernels.scale_bias_relu.launches == 0


@pytest.mark.parametrize("residual", [False, True])
def test_op_matches_flax_batchnorm_then_pallas(residual):
    """float32 operator against flax's eval-mode BatchNorm (the JAX model's
    ``make_norm``) on the same numpy parameters, followed by the Pallas
    epilogue in interpret mode (scale 1, bias 0, the residual): within 1e-6,
    as tests/test_torch_ops.py holds the unfolded epilogue."""
    x, w, b, m, v, res = bn_case(torch.float32, residual)
    got = OPS.batch_norm_relu(x, w, b, m, v, EPS, res)
    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())
    norm = jax_make_norm(epsilon=EPS)(use_running_average=True)
    y = norm.apply({"params": {"scale": jnp.asarray(w.numpy()),
                               "bias": jnp.asarray(b.numpy())},
                    "batch_stats": {"mean": jnp.asarray(m.numpy()),
                                    "var": jnp.asarray(v.numpy())}}, nhwc(x))
    want = np.asarray(fused_scale_bias_relu(
        y, jnp.ones((C,), jnp.float32), jnp.zeros((C,), jnp.float32),
        None if res is None else nhwc(res), interpret=True))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_forward_kernel_path_equals_plain(dtype, monkeypatch):
    """The flagship's eval forward at B=2, 64x96: every one of its 84
    BN->ReLU sites goes through ``batch_norm_relu`` on the kernel path and
    none on the plain path, and the two predictions are bit-equal."""
    calls = []
    wrapped = kernels.batch_norm_relu

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(kernels, "batch_norm_relu", counting)
    model, spec = create_model("resnet18_multistage", device="cpu",
                               dtype=getattr(torch, dtype),
                               output_size=(H, W))
    init_random(model, 0)
    rng = np.random.default_rng(1)
    prepared = {"rgb": torch.from_numpy(rng.uniform(
                    0, 1, (B, H, W, 3)).astype(np.float32)),
                "radar": torch.from_numpy(rng.uniform(
                    0, 50, (B, H, W, 1)).astype(np.float32))}
    inputs = pack_model_inputs(prepared, spec.input_kind)
    with torch.inference_mode():
        got = model(*inputs)
        assert len(calls) == 84
        want = use_plain_kernels(model)(*inputs)
        assert len(calls) == 84
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)


def test_wrapper_checks_and_devices():
    """The wrapper refuses what the kernel does not take, and a tensor on
    the meta device; the operator there gives the fake implementation's
    empty output, channels_last kept."""
    x, w, b, m, v, res = bn_case(torch.bfloat16, True)
    with pytest.raises(ValueError, match="running_var"):
        kernels.batch_norm_relu(x, w, b, m, v[:8], EPS, res)
    with pytest.raises(ValueError, match="running_mean"):
        kernels.batch_norm_relu(x, w, b, m.double(), v, EPS, res)
    with pytest.raises(ValueError, match="residual"):
        kernels.batch_norm_relu(x, w, b, m, v, EPS, res.float())
    with pytest.raises(ValueError, match="channels_last"):
        kernels.batch_norm_relu(x.contiguous(), w, b, m, v, EPS)
    with pytest.raises(TypeError):
        kernels.batch_norm_relu(x.half(), w, b, m, v, EPS)
    meta = [a.to("meta") for a in (x, w, b, m, v)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernels.batch_norm_relu(*meta, EPS)
    out = OPS.batch_norm_relu(*meta, EPS, res.to("meta"))
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert out.shape == x.shape and out.stride() == x.stride()
