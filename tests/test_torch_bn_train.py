"""Kernel D's plain path, the train-mode BatchNorm (radar_depth_tpu_torch/
ops/kernels.py::bn_train_moments, bn_train_apply), on the CPU at B=2,
64x96 with a few channels: the forward bit-equal to the former plain
train-mode BN (torch.var_mean, then the float32 normalization, the cast, the
residual add and the ReLU under autograd) in float32 and bfloat16, with and
without the residual and the ReLU, and its gradients within float rounding
of that formula's; the running update with ``update_stats`` on and off;
float64 ``gradcheck`` of the backward formulas (each node alone and the two
joined by their link); flax's train-mode BatchNorm on the same numpy inputs
(output, batch statistics and gradients within 1e-5); the four kernel
wrappers on the CPU are their plain versions and count no launch; and the
reducing passes' plan covers every row once.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_gpu.py (skipped without a card) and by chip_smoke.py's
phase bn_train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_depth_tpu.models.layers import make_norm as jax_make_norm
from radar_depth_tpu_torch.models import BatchNorm
from radar_depth_tpu_torch.models.layers import frozen_running_stats
from radar_depth_tpu_torch.ops import kernels

B, H, W, C = 2, 64, 96, 12
EPS = 1e-5
MOMENTUM = 0.9
VARIANTS = [(False, False), (True, False), (True, True)]  # (relu, residual)
VARIANT_IDS = ["bn", "bn_relu", "bn_add_relu"]
# gradients of the new formulas against autograd through the former ones,
# both dtypes compared in float32: the same float32 terms summed in another
# order (2 to 4 ulps of the largest term at this size; a bf16 gradient is
# rounded from those sums)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
FLAX_TOL = dict(atol=1e-5, rtol=1e-5)  # float32, two frameworks' sums


def act(rng, dtype, channels=C, scale=2.0, shift=0.5):
    """(B, channels, H, W) in channels_last memory, drawn with numpy."""
    a = rng.normal(size=(B, H, W, channels)).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def params(rng, channels=C):
    """The BN's float32 (weight, bias, running_mean, running_var) as
    tests/test_torch_models.py draws them."""
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return (f(rng.uniform(0.5, 1.5, channels)),
            f(rng.normal(size=channels) * 0.1),
            f(rng.normal(size=channels) * 0.1),
            f(rng.uniform(0.5, 1.5, channels)))


def former_train_forward(x, weight, bias, running_mean, running_var, relu,
                         residual, update=True):
    """The plain train-mode BN before kernel D (models/layers.py), written
    out: var_mean over (N, H, W) in float32, the running update, then the
    float32 normalization, the cast, the residual add and the ReLU."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    if update:
        with torch.no_grad():
            running_mean.copy_(MOMENTUM * running_mean + (1 - MOMENTUM) * mean)
            running_var.copy_(MOMENTUM * running_var + (1 - MOMENTUM) * var)
    mul = torch.rsqrt(var + EPS) * weight
    y = ((xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
         + bias.view(1, -1, 1, 1)).to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def bn_module(weight, bias, mean, var):
    bn = BatchNorm(C, epsilon=EPS, momentum=MOMENTUM, device="cpu").train()
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(v)
    return bn


@pytest.mark.parametrize("relu,residual", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_running_update_bit_equal_to_former_bn(dtype, relu,
                                                           residual):
    """BatchNorm's train forward through the two nodes: the output and the
    moved running statistics have the former formula's bits."""
    t = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = act(rng, t)
    res = act(rng, t, shift=0.0) if residual else None
    w, b, m, v = params(rng)
    bn = bn_module(w, b, m, v)
    rm, rv = m.clone(), v.clone()
    got = bn(x, relu=relu, residual=res)
    want = former_train_forward(x, w, b, rm, rv, relu, res)
    assert got.dtype == t and torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm)
    assert torch.equal(bn.running_var, rv)


@pytest.mark.parametrize("relu,residual", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_former_bn_autograd(dtype, relu, residual):
    """x's, the residual's, the weight's and the bias's gradients against
    autograd through the former formula, within float rounding; x's and
    the residual's in their own dtype, the parameters' float32."""
    t = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    x = act(rng, t)
    res = act(rng, t, shift=0.0) if residual else None
    dy = act(rng, t, scale=1.0, shift=0.0)
    w, b, m, v = params(rng)
    runs = []
    for new in (True, False):
        xi = x.clone().requires_grad_(True)
        ri = None if res is None else res.clone().requires_grad_(True)
        bn = bn_module(w, b, m, v)
        if new:
            y = bn(xi, relu=relu, residual=ri)
        else:
            y = former_train_forward(xi, bn.weight, bn.bias, bn.running_mean,
                                     bn.running_var, relu, ri)
        ins = [xi, bn.weight, bn.bias] + ([ri] if ri is not None else [])
        runs.append(torch.autograd.grad(y, ins, dy))
    for got, want in zip(*runs):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), **GRAD_TOL)


@pytest.mark.parametrize("relu,residual", VARIANTS, ids=VARIANT_IDS)
def test_gradcheck_float64(relu, residual):
    """float64 gradcheck of the plain backward formulas: the moments alone,
    the apply alone (mean and var as inputs, x's gradient its own part),
    and the two joined by their link, as BatchNorm calls them."""
    g = torch.Generator().manual_seed(3)
    d = dict(dtype=torch.float64)
    x = (torch.randn(2, 3, 4, 5, generator=g, **d) * 2 + 1).requires_grad_()
    w = (torch.rand(3, generator=g, **d) + 0.5).requires_grad_()
    b = torch.randn(3, generator=g, **d).requires_grad_()
    mean = torch.randn(3, generator=g, **d).requires_grad_()
    var = (torch.rand(3, generator=g, **d) + 0.5).requires_grad_()
    r = (torch.randn(2, 3, 4, 5, generator=g, **d).requires_grad_()
         if residual else None)
    extra = (r,) if residual else ()

    def joined(x, w, b, *r):
        link = kernels.BnTrainLink()
        mu, s2 = kernels.bn_train_moments(x, link=link)
        return kernels.bn_train_apply(x, mu, s2, w, b, EPS, *r, relu=relu,
                                      link=link)

    def apply_alone(x, mean, var, w, b, *r):
        return kernels.bn_train_apply(x, mean, var, w, b, EPS, *r, relu=relu)

    assert torch.autograd.gradcheck(kernels.bn_train_moments, (x,))
    assert torch.autograd.gradcheck(apply_alone, (x, mean, var, w, b, *extra))
    assert torch.autograd.gradcheck(joined, (x, w, b, *extra))


def test_link_sums_both_parts_of_x_gradient():
    """With the link, the moments' backward writes x's whole gradient: the
    apply's part plus the moments' part, each as its node gives it alone
    (float64)."""
    rng = np.random.default_rng(4)
    x = act(rng, torch.float64)
    dy = act(rng, torch.float64, scale=1.0, shift=0.0)
    w, b, _, _ = (p.double() for p in params(rng))

    def grads(linked):
        xi = x.clone().requires_grad_(True)
        link = kernels.BnTrainLink() if linked else None
        mean, var = kernels.bn_train_moments(xi, link=link)
        if not linked:  # the two parts of x's gradient, each on its own
            mean_d, var_d = mean.detach().requires_grad_(), var.detach()
            var_d.requires_grad_()
            y = kernels.bn_train_apply(xi, mean_d, var_d, w, b, EPS,
                                       relu=True)
            dx_apply, dmean, dvar = torch.autograd.grad(y, (xi, mean_d,
                                                            var_d), dy)
            dx_moments, = torch.autograd.grad((mean, var), (xi,),
                                              (dmean, dvar))
            return dx_apply + dx_moments
        y = kernels.bn_train_apply(xi, mean, var, w, b, EPS, relu=True,
                                   link=link)
        dx, = torch.autograd.grad(y, (xi,), dy)
        assert link.pending is None  # consumed by the moments' backward
        return dx

    torch.testing.assert_close(grads(True), grads(False), atol=1e-12,
                               rtol=1e-12)


@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_running_update_follows_update_stats(update):
    """``update_stats`` True moves the running statistics by 0.9*old +
    0.1*batch with the biased variance, bit-equal to the former (C,) ops;
    False (``frozen_running_stats``, the recompute of a checkpointed stage)
    leaves them alone, and the output is the same either way."""
    rng = np.random.default_rng(5)
    x = act(rng, torch.float32)
    w, b, m, v = params(rng)
    bn = bn_module(w, b, m, v)
    rm, rv = m.clone(), v.clone()
    want = former_train_forward(x, w, b, rm, rv, True, None, update=update)
    if update:
        got = bn(x, relu=True)
    else:
        with frozen_running_stats(bn):
            got = bn(x, relu=True)
        assert bn.update_stats
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm if update else m)
    assert torch.equal(bn.running_var, rv if update else v)
    if update:
        assert not torch.equal(rm, m) and not torch.equal(rv, v)


@pytest.mark.parametrize("relu,residual", VARIANTS, ids=VARIANT_IDS)
def test_train_bn_matches_flax_batchnorm(relu, residual):
    """float32 train-mode BN against flax's BatchNorm (the JAX model's
    ``make_norm``, ``use_running_average=False``) followed by the residual
    add and the ReLU, on the same numpy inputs: the output, the moved batch
    statistics and the gradients of x, scale and bias within 1e-5."""
    rng = np.random.default_rng(6)
    x = act(rng, torch.float32)
    res = act(rng, torch.float32, shift=0.0) if residual else None
    dy = act(rng, torch.float32, scale=1.0, shift=0.0)
    w, b, m, v = params(rng)
    bn = bn_module(w, b, m, v)
    xi = x.clone().requires_grad_(True)
    y = bn(xi, relu=relu, residual=res)
    gx, gw, gb = torch.autograd.grad(y, (xi, bn.weight, bn.bias), dy)

    nhwc = lambda t: jnp.asarray(t.detach().permute(0, 2, 3, 1).numpy())
    norm = jax_make_norm(epsilon=EPS)(use_running_average=False)
    stats = {"mean": jnp.asarray(m.numpy()), "var": jnp.asarray(v.numpy())}

    def f(xj, scale, bias):
        out, upd = norm.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": stats}, xj,
                              mutable=["batch_stats"])
        if res is not None:
            out = out + nhwc(res)
        return (jax.nn.relu(out) if relu else out), upd["batch_stats"]

    (want, new_stats), vjp = jax.vjp(f, nhwc(x), jnp.asarray(w.numpy()),
                                     jnp.asarray(b.numpy()), has_aux=False)
    wx, ww, wb = vjp((nhwc(dy), jax.tree_util.tree_map(jnp.zeros_like,
                                                       new_stats)))
    to_nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(to_nhwc(y), np.asarray(want), **FLAX_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), **FLAX_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), **FLAX_TOL)
    np.testing.assert_allclose(to_nhwc(gx), np.asarray(wx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-4,
                               rtol=1e-4)


def test_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the four kernel-D wrappers return their plain
    versions' results and count no launch."""
    for fn in (kernels.bn_stats, kernels.bn_apply, kernels.bn_grad_stats,
               kernels.bn_grad_input):
        fn.launches = 0
    rng = np.random.default_rng(7)
    x, res, dy = (act(rng, torch.bfloat16) for _ in range(3))
    w, b, m, v = params(rng)
    mean, var = kernels.bn_stats(x)
    for got, want in zip((mean, var), kernels.bn_stats_reference(x)):
        assert torch.equal(got, want)
    y = kernels.bn_apply(x, mean, var, w, b, EPS, res, True)
    assert torch.equal(y, kernels.bn_apply_reference(x, mean, var, w, b, EPS,
                                                     res, True))
    got = kernels.bn_grad_stats(dy, y, x, mean, var, w, EPS, True, True)
    want = kernels.bn_grad_stats_reference(dy, y, x, mean, var, w, EPS, True,
                                           True)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    dx = kernels.bn_grad_input(dy, y, x, mean, var, w, EPS, got[3], got[4],
                               True)
    assert torch.equal(dx, kernels.bn_grad_input_reference(
        dy, y, x, mean, var, w, EPS, got[3], got[4], True))
    assert dx.dtype == torch.bfloat16
    assert [fn.launches for fn in (kernels.bn_stats, kernels.bn_apply,
                                   kernels.bn_grad_stats,
                                   kernels.bn_grad_input)] == [0, 0, 0, 0]


@pytest.mark.parametrize("rows,channels,lanes", [
    (32 * 15 * 25, 512, 8), (32 * 225 * 400, 64, 8),
    (32 * 240 * 400, 16, 8), (8 * 113 * 200, 64, 4), (1, 24, 8),
    (3 * 7 * 9, 5, 1), (5 * 17 * 19, 33, 1)])
def test_reduce_plan_covers_every_row_once(rows, channels, lanes):
    """The reducing passes' plan at the flagship's extreme sites and odd
    shapes: a power-of-two tile width up to 32 with 256 threads a block,
    chunks of whole thread rows (at least 4 each) that cover every row
    once, and no more chunks than the grid's y extent takes."""
    groups = channels // lanes
    tx, chunk_rows, chunks = kernels.bn_reduce_plan(rows, groups, 132)
    ty = 256 // tx
    assert tx & (tx - 1) == 0 and tx <= 32 and (tx >= groups or tx == 32)
    assert chunk_rows % ty == 0 and chunk_rows >= 4 * ty
    assert (chunks - 1) * chunk_rows < rows <= chunks * chunk_rows
    assert chunks <= 65535


def test_card_checks_refuse_what_the_kernel_does_not_take():
    """The card path's argument checks: channels_last NCHW float32 or
    bfloat16, not empty, the other tensors alike, the (C,) vectors float32
    and contiguous."""
    x = torch.zeros(2, 8, 3, 4).contiguous(memory_format=torch.channels_last)
    kernels._check_bn_x(x, x.clone())
    with pytest.raises(ValueError):
        kernels._check_bn_x(x.contiguous())
    with pytest.raises(TypeError):
        kernels._check_bn_x(x.double())
    with pytest.raises(ValueError):
        kernels._check_bn_x(x[:0])
    with pytest.raises(ValueError):
        kernels._check_bn_x(x, x.to(torch.bfloat16))
    kernels._check_bn_params(x, weight=torch.ones(8))
    with pytest.raises(ValueError):
        kernels._check_bn_params(x, weight=torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels._check_bn_params(x, weight=torch.ones(16)[::2])
