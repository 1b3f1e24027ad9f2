"""The port's losses and metrics against the JAX package's, on numpy inputs
from a seed: float32 sums within rtol 1e-5 (the same formulas, summed in
another order), including all-invalid padding samples and empty masks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radar_depth_tpu.metrics as jm
import radar_depth_tpu.objectives as jo
from radar_depth_tpu_torch import metrics as tm
from radar_depth_tpu_torch import objectives as to

RTOL = 1e-5


def _pred_target(seed, n=4, h=12, w=16, pad=1):
    """Positive predictions and a sparse target; the last ``pad`` samples
    have no valid pixel (padding of a ragged eval tail)."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.5, 60, size=(n, h, w, 1)).astype(np.float32)
    target = ((rng.uniform(size=(n, h, w, 1)) > 0.7)
              * rng.uniform(1, 80, size=(n, h, w, 1))).astype(np.float32)
    target[n - pad:] = 0
    return pred, target


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0)


@pytest.mark.parametrize("criterion", ["l1", "l2"])
def test_losses_match_jax(criterion):
    pred, target = _pred_target(0)
    pred2 = pred * 1.1
    tp, tt, tp2 = map(torch.from_numpy, (pred, target, pred2))
    jp, jt, jp2 = map(jnp.asarray, (pred, target, pred2))
    _close(to.get_loss(criterion)(tp, tt), jo.get_loss(criterion)(jp, jt))
    _close(to.multistage_loss((tp, tp2), tt, criterion, (0.3, 1.7)),
           jo.multistage_loss((jp, jp2), jt, criterion, (0.3, 1.7)))
    log_var = np.asarray([0.2, -0.4], np.float32)
    _close(to.multistage_uncertainty_loss((tp, tp2), torch.from_numpy(log_var),
                                          tt, criterion),
           jo.multistage_uncertainty_loss((jp, jp2), jnp.asarray(log_var), jt,
                                          criterion))
    empty = torch.zeros_like(tt)
    assert float(to.get_loss(criterion)(tp, empty)) == 0.0
    with pytest.raises(KeyError, match="criterion"):
        to.get_loss("l3")


def test_loss_reduces_bfloat16_in_float32():
    pred, target = _pred_target(1)
    got = to.masked_l1_loss(torch.from_numpy(pred).bfloat16(),
                            torch.from_numpy(target))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("convention", ["batch", "sample"])
@pytest.mark.parametrize("pad", [0, 1, 4])
def test_metric_sums_match_jax(convention, pad):
    """Every field and the count; pad=4 is a batch with no valid pixel at
    all (every sum and the count 0)."""
    pred, target = _pred_target(2, pad=pad)
    want = jm.compute_metric_sums(jnp.asarray(pred), jnp.asarray(target),
                                  convention)
    got = tm.compute_metric_sums(torch.from_numpy(pred),
                                 torch.from_numpy(target), convention)
    assert set(got) == set(want) == set(tm.METRIC_FIELDS) | {"count"}
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=0, err_msg=k)
    assert float(got["count"]) == 4 - pad
    with pytest.raises(ValueError, match="convention"):
        tm.compute_metric_sums(torch.from_numpy(pred),
                               torch.from_numpy(target), "pixel")


def test_accumulate_and_finalize_match_jax():
    """Sums over three batches, then the host-side divide."""
    acc_t = tm.zeros_metric_sums()
    acc_j = jm.zeros_metric_sums()
    for seed in range(3):
        pred, target = _pred_target(10 + seed)
        acc_t = tm.accumulate_metric_sums(acc_t, tm.compute_metric_sums(
            torch.from_numpy(pred), torch.from_numpy(target), "batch"))
        acc_j = jm.accumulate_metric_sums(acc_j, jm.compute_metric_sums(
            jnp.asarray(pred), jnp.asarray(target), "batch"))
    got, want = tm.finalize_metrics(acc_t), jm.finalize_metrics(acc_j)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert tm.finalize_metrics(tm.zeros_metric_sums())["rmse"] == 0.0


def test_average_meter_and_fields_match_jax():
    assert tm.METRIC_FIELDS == jm.METRIC_FIELDS
    assert tm.CSV_FIELDS == jm.CSV_FIELDS
    a, b = tm.AverageMeter(), jm.AverageMeter()
    assert a.average == b.average == 0.0
    for v, n in ((0.5, 8), (1.5, 2), (0.25, 8)):
        a.update(v, n)
        b.update(v, n)
    assert a.average == b.average and a.count == b.count == 18
