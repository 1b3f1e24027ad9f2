"""Depth metrics on the device, mirroring ``radar_depth_tpu/metrics/
__init__.py`` (the reference's Result / AverageMeter).

Metrics are a flat dict of (at least) float32 sums plus the count needed to
finish the averages, so batches add up on the device and the divide happens
once on the host (``finalize_metrics``). Over the target > 0 mask: irmse, imae
(1/km), mse, rmse, mae (m), absrel, lg10, delta < 1.25 / 1.25^2 / 1.25^3.

Conventions: "batch" is the reference's AverageMeter weighting (all valid
pixels of the batch pooled into one value, weighted by the number of
samples with a valid pixel); "sample" averages per-sample pixel means.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from radar_depth_tpu_torch.parallel.mesh import all_reduce_sum, is_distributed
from radar_depth_tpu_torch.parallel.spatial import is_spatial

METRIC_FIELDS = (
    "irmse", "imae", "mse", "rmse", "mae", "absrel", "lg10",
    "delta1", "delta2", "delta3",
)
CSV_FIELDS = ("mse", "rmse", "absrel", "lg10", "mae",
              "delta1", "delta2", "delta3", "data_time", "gpu_time")


def _per_sample_mean(x: torch.Tensor, mask: torch.Tensor):
    """Mean over valid pixels per sample: (N, ...) -> (N,), 0 where empty;
    and the per-sample valid counts."""
    axes = tuple(range(1, x.dim()))
    total = torch.where(mask, x, torch.zeros((), device=x.device)).sum(axes)
    count = mask.sum(axes)
    mean = torch.where(count > 0, total / count.clamp_min(1),
                       torch.zeros((), device=x.device))
    return mean, count


def _masked_total(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over every valid pixel of the batch."""
    return torch.where(valid, x, torch.zeros((), device=x.device)).sum()


def _pooled_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.where(count > 0, total / count.clamp_min(1),
                       torch.zeros((), device=total.device))


def _per_pixel_terms(pred: torch.Tensor, target: torch.Tensor, valid):
    """{name: per-pixel term} whose valid-pixel means are the metrics
    (``imse`` is squared under ``irmse``; ``rmse`` comes from ``mse``)."""
    dtype = pred.dtype
    safe_pred = pred.clamp_min(1e-6)  # guards log/division; masked anyway
    safe_target = torch.where(valid, target, torch.ones((), device=pred.device))
    abs_diff = (pred - target).abs()
    terms = {"mse": torch.square(pred - target), "mae": abs_diff,
             "absrel": abs_diff / safe_target,
             "lg10": (torch.log10(safe_pred) - torch.log10(safe_target)).abs()}
    max_ratio = torch.maximum(safe_pred / safe_target, safe_target / safe_pred)
    for i in (1, 2, 3):
        terms[f"delta{i}"] = (max_ratio < 1.25 ** i).to(dtype)
    # inverse metrics in 1/km: a 10 m return is 100 km^-1
    inv_pred = 1.0 / (1e-3 * safe_pred)
    inv_target = 1.0 / (1e-3 * safe_target)
    terms["imse"] = torch.square(inv_pred - inv_target)
    terms["imae"] = (inv_pred - inv_target).abs()
    return terms


def _finish_sqrt(per: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # sqrt at the granularity of one evaluation: per sample or per batch
    per["rmse"] = torch.sqrt(per["mse"])
    per["irmse"] = torch.sqrt(per.pop("imse"))
    return per


def compute_metric_sums(pred: torch.Tensor, target: torch.Tensor,
                        convention: str = "sample",
                        mesh=None) -> Dict[str, torch.Tensor]:
    """One batch -> dict of scalar sums and "count" (finish with
    ``finalize_metrics``: metric = sum / count).

    "sample": per-sample pixel means summed over the samples that have a
    valid pixel; count = those samples. "batch": the batch-pooled value times
    n, count = n, where n is the number of samples with a valid pixel (an
    all-invalid padding sample counts for nothing in either).

    ``mesh`` (a ``parallel.mesh.DataMesh`` with a process group): the batch
    is this rank's rows of the global batch and the sums are the global
    batch's, the same on every rank. "sample" sums add over ranks; "batch"
    pools the pixel totals, the valid count and n over ranks before the
    divide and the square roots. With a space axis the tensors are row
    slabs of this rank's samples (``_spatial_sums``).
    """
    dtype = torch.promote_types(pred.dtype, torch.float32)
    pred = pred.to(dtype)
    target = target.to(dtype)
    valid = target > 0
    terms = _per_pixel_terms(pred, target, valid)
    if is_spatial(mesh):
        return _spatial_sums(terms, valid, convention, mesh, dtype)

    if convention == "batch":
        count = valid.sum()
        totals = {k: _masked_total(x, valid) for k, x in terms.items()}
        n = valid.flatten(1).any(dim=1).to(dtype).sum()
        if is_distributed(mesh):
            names = list(totals)
            *reduced, count, n = all_reduce_sum(
                [totals[k] for k in names] + [count, n], mesh,
                dtype=torch.float64)
            totals = dict(zip(names, reduced))
        per = _finish_sqrt({k: _pooled_mean(t, count)
                            for k, t in totals.items()})
        sums = {name: val * n for name, val in per.items()}
        sums["count"] = n
        return sums
    if convention != "sample":
        raise ValueError(f"unknown metric convention {convention!r}")
    per = {}
    for k, x in terms.items():
        per[k], count = _per_sample_mean(x, valid)
    per = _finish_sqrt(per)
    has_valid = (count > 0).to(dtype)
    sums = {name: (val * has_valid).sum() for name, val in per.items()}
    sums["count"] = has_valid.sum()
    if is_distributed(mesh):
        names = list(sums)
        sums = dict(zip(names, all_reduce_sum([sums[k] for k in names], mesh,
                                              dtype=torch.float64)))
    return sums


def _spatial_sums(terms: Dict[str, torch.Tensor], valid: torch.Tensor,
                  convention: str, mesh, dtype) -> Dict[str, torch.Tensor]:
    """The metric sums of the global batch from row slabs: a table of each
    sample's masked pixel totals and valid count, with one row per sample
    of the global batch, zero but for this rank's own samples' rows, is
    summed over the world (the slabs of a sample add up to its totals), so
    every rank finishes the same sums from whole samples, as one process
    does: per-sample means and square roots ("sample"), or the pooled
    totals and n, the samples with a valid pixel in any slab ("batch")."""
    if convention not in ("batch", "sample"):
        raise ValueError(f"unknown metric convention {convention!r}")
    names = list(terms)
    axes = tuple(range(1, valid.dim()))
    zero = torch.zeros((), dtype=dtype, device=valid.device)
    part = torch.stack([torch.where(valid, terms[k], zero).sum(axes)
                        for k in names] + [valid.sum(axes).to(dtype)], 1)
    n = part.shape[0]
    table = torch.zeros((n * mesh.data_size, len(names) + 1),
                        dtype=torch.float64, device=valid.device)
    table[mesh.data_index * n:(mesh.data_index + 1) * n] = part
    table, = all_reduce_sum([table], mesh)
    table = table.to(dtype)
    totals, count = table[:, :-1], table[:, -1]
    has_valid = (count > 0).to(dtype)
    if convention == "batch":
        per = _finish_sqrt({k: _pooled_mean(totals[:, i].sum(), count.sum())
                            for i, k in enumerate(names)})
        n_valid = has_valid.sum()
        sums = {name: val * n_valid for name, val in per.items()}
        sums["count"] = n_valid
        return sums
    per = _finish_sqrt({k: _pooled_mean(totals[:, i], count)
                        for i, k in enumerate(names)})
    sums = {name: (val * has_valid).sum() for name, val in per.items()}
    sums["count"] = has_valid.sum()
    return sums


def zeros_metric_sums(device: str | torch.device = "cpu"
                      ) -> Dict[str, torch.Tensor]:
    out = {k: torch.zeros((), device=device) for k in METRIC_FIELDS}
    out["count"] = torch.zeros((), device=device)
    return out


def accumulate_metric_sums(acc: Dict, new: Dict) -> Dict:
    """AverageMeter.update equivalent: running sums add."""
    return {k: acc[k] + new[k] for k in acc}


def finalize_metrics(sums: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Host-side finish: each sum divided by the sample count."""
    count = float(sums["count"])
    out = {k: float(sums[k]) / count if count > 0 else 0.0
           for k in METRIC_FIELDS}
    out["count"] = count
    return out


@dataclasses.dataclass
class AverageMeter:
    """Host-side running average for wall-clock fields (data_time,
    gpu_time), the reference AverageMeter's contract."""

    total: float = 0.0
    count: float = 0.0

    def update(self, value: float, n: int = 1) -> None:
        self.total += float(value) * n
        self.count += n

    @property
    def average(self) -> float:
        return self.total / self.count if self.count else 0.0
