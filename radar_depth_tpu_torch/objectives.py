"""Masked depth losses, mirroring ``radar_depth_tpu/objectives/__init__.py``
(the reference's MaskedL1Loss / MaskedMSELoss): mask = target > 0, mean over
the valid pixels only, 0 for an empty mask. Reductions run in (at least)
float32 whatever the prediction's dtype.

``mesh``: a ``parallel.mesh.DataMesh`` with a process group. Each rank then
divides its own masked total by the valid count of the global batch, so its
loss is its share ``L_r`` and ``sum_r L_r`` is the loss of the global batch;
each rank differentiates its ``L_r``. None: the batch is the whole batch.
"""

from __future__ import annotations

import torch

from radar_depth_tpu_torch.parallel.mesh import all_reduce_sum, is_distributed


def _masked_mean(err: torch.Tensor, mask: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    err = err.to(torch.promote_types(err.dtype, torch.float32))
    mask = mask.to(err.dtype)
    total = (err * mask).sum()
    count = mask.sum()
    if is_distributed(mesh):  # the count carries no gradient
        count, = all_reduce_sum([count], mesh)
    return torch.where(count > 0, total / count.clamp_min(1.0),
                       torch.zeros((), dtype=err.dtype, device=err.device))


def masked_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Mean |pred - target| over target > 0."""
    return _masked_mean((pred - target).abs(), target > 0, mesh)


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """Mean (pred - target)^2 over target > 0."""
    diff = pred - target
    return _masked_mean(diff * diff, target > 0, mesh)


LOSSES = {"l1": masked_l1_loss, "l2": masked_mse_loss}


def get_loss(name: str):
    """Resolve a criterion name ("l1" | "l2")."""
    if name not in LOSSES:
        raise KeyError(f"unknown criterion {name!r}; have {sorted(LOSSES)}")
    return LOSSES[name]


def multistage_loss(preds, target: torch.Tensor, criterion: str = "l1",
                    stage_weights=(1.0, 1.0), mesh=None) -> torch.Tensor:
    """Weighted sum of the per-stage masked losses over (coarse, refined)."""
    fn = get_loss(criterion)
    total = 0.0
    for w, p in zip(stage_weights, preds):
        total = total + w * fn(p, target, mesh)
    return total


def multistage_uncertainty_loss(preds, log_var: torch.Tensor,
                                target: torch.Tensor,
                                criterion: str = "l1",
                                mesh=None) -> torch.Tensor:
    """Sum over stages of exp(-s_i) * loss_i + s_i, with learned per-stage
    log-variances s (homoscedastic weighting). Over a mesh the ``+ s_i``
    term of the global loss is shared out as ``s_i / world`` per rank."""
    fn = get_loss(criterion)
    world = mesh.world if is_distributed(mesh) else 1
    total = 0.0
    for i, p in enumerate(preds):
        s = log_var[i].float()
        reg = s if world == 1 else s / world
        total = total + torch.exp(-s) * fn(p, target, mesh) + reg
    return total
