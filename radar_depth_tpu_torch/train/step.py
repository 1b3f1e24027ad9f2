"""Train and eval steps, mirroring ``radar_depth_tpu/train/step.py``.

One train step is the whole per-batch pipeline: on-device preprocessing and
augmentation (kernel C z-buffers the augmented radar, and with
``gt_augment="rerasterize"`` the LiDAR GT) -> two-stage forward with BN in
train mode -> masked multistage loss -> backward -> SGD update, with metric
sums on the device. The eval step runs the eval-mode forward (kernel B at
every BN->ReLU) on the eval preprocessing. Raw schema batches go in; the
steps return dicts of device scalars and do not wait for the card.

The model is the state: a step updates its parameters and BN running
statistics in place, where the JAX step returns new ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from radar_depth_tpu_torch.config import TrainConfig
from radar_depth_tpu_torch.metrics import compute_metric_sums
from radar_depth_tpu_torch.models import (
    ArchSpec,
    blend_by_brightness,
    use_plain_kernels,
)
from radar_depth_tpu_torch.objectives import get_loss, multistage_loss
from radar_depth_tpu_torch.ops.preprocess import (
    PreprocessConfig,
    pack_model_inputs,
    prepare_eval_batch,
    prepare_train_batch,
)
from radar_depth_tpu_torch.train.state import TrainState


def make_preprocess_config(cfg: TrainConfig) -> PreprocessConfig:
    return PreprocessConfig(
        spec=cfg.data.sample_spec(),
        height_extension=cfg.data.height_extension,
        augment=cfg.augment,
        raster_backend=cfg.data.raster_backend,
        gt_augment=cfg.data.gt_augment,
    )


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _loss_and_pred(out, target, cfg: TrainConfig, spec: ArchSpec, rgb=None):
    """``rgb`` (eval only) turns on the ``blend_tau`` output policy, so the
    metrics score the served output; the loss is always the multistage sum
    over both heads."""
    if spec.multistage:
        loss = multistage_loss(out, target, cfg.optim.criterion,
                               cfg.optim.stage_weights)
        pred = out[1]
        if rgb is not None and cfg.model.blend_tau > 0:
            pred = blend_by_brightness(out[0], out[1], rgb,
                                       cfg.model.blend_tau)
    else:
        loss = get_loss(cfg.optim.criterion)(out, target)
        pred = out
    return loss, pred


def make_micro_grad_fn(model: torch.nn.Module, spec: ArchSpec,
                       cfg: TrainConfig, plain: bool = False) -> Callable:
    """One micro-batch of the train step without the optimizer update:
    ``micro_grads(batch, aug_params=None, generator=None) -> (grads, sums)``
    with ``grads`` {parameter name: gradient}. The forward runs in train
    mode, so the model's BN running statistics move, in place.

    The augmentation parameters are ``aug_params`` or drawn from
    ``generator`` (``ops/preprocess.py::prepare_train_batch``). ``plain=True``
    runs the z-buffer's plain version (the reference on the card); kernel B
    does not run in train mode."""
    pre = make_preprocess_config(cfg)
    names, params = zip(*model.named_parameters())

    def micro_grads(batch: Dict, aug_params=None,
                    generator: torch.Generator | None = None):
        model.train()
        prepared = prepare_train_batch(batch, pre, aug_params, generator,
                                       _device(model), plain)
        target = prepared["target"]
        out = model(*pack_model_inputs(prepared, spec.input_kind))
        loss, pred = _loss_and_pred(out, target, cfg, spec)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            sums = compute_metric_sums(pred, target, cfg.metric_avg)
        sums["loss"] = loss.detach().float()
        return dict(zip(names, grads)), sums

    return micro_grads


def make_train_step(model: torch.nn.Module, spec: ArchSpec, cfg: TrainConfig,
                    plain: bool = False) -> Callable:
    """``train_step(state, batch, generator=None, aug_params=None) -> sums``
    for ``state.model is model``; advances ``state`` in place.

    With ``cfg.optim.grad_accum`` = N > 1 the batch's leaves are stacked
    (N, B, ...) and ``aug_params``, if given, is a sequence of N parameter
    tuples: the micro-batches run in order, BN statistics carried from one
    to the next, their gradients averaged into one update; the metric sums
    add up and the loss is divided by N, so its scale matches the plain
    step."""
    micro_grads = make_micro_grad_fn(model, spec, cfg, plain)
    accum = max(1, cfg.optim.grad_accum)

    def apply_update(state: TrainState, grads: Dict[str, torch.Tensor]):
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1

    def train_step(state: TrainState, batch: Dict,
                   generator: torch.Generator | None = None,
                   aug_params: Sequence | None = None) -> Dict:
        if state.model is not model:
            raise ValueError("state.model is not the model of this step")
        if accum == 1:
            grads, sums = micro_grads(batch, aug_params, generator)
            apply_update(state, grads)
            return sums
        grads, sums = None, None
        for i in range(accum):
            g, s = micro_grads({k: v[i] for k, v in batch.items()},
                               None if aug_params is None else aug_params[i],
                               generator)
            if grads is None:
                grads, sums = g, s
            else:
                grads = {k: grads[k] + g[k] for k in grads}
                sums = {k: sums[k] + s[k] for k in sums}
        sums["loss"] = sums["loss"] / accum
        apply_update(state, {k: g / accum for k, g in grads.items()})
        return sums

    return train_step


def make_eval_step(model: torch.nn.Module, spec: ArchSpec, cfg: TrainConfig,
                   plain: bool = False) -> Callable:
    """``eval_step(batch) -> sums``: the eval preprocessing (kernel C or A
    z-buffer) and the eval-mode forward (kernel B), the multistage loss and
    the metric sums of the served output (``blend_tau``). ``plain=True``
    runs every kernel's plain version."""
    pre = make_preprocess_config(cfg)

    @torch.no_grad()
    def eval_step(batch: Dict) -> Dict:
        use_plain_kernels(model.eval(), plain)
        prepared = prepare_eval_batch(batch, pre, _device(model), plain)
        out = model(*pack_model_inputs(prepared, spec.input_kind))
        loss, pred = _loss_and_pred(out, prepared["target"], cfg, spec,
                                    rgb=prepared["rgb"])
        sums = compute_metric_sums(pred, prepared["target"], cfg.metric_avg)
        sums["loss"] = loss.float()
        return sums

    return eval_step
