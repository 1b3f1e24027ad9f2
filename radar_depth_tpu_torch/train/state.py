"""Train state and optimizer with the reference's SGD semantics, mirroring
``radar_depth_tpu/train/state.py``.

``torch.optim.SGD(lr, momentum, weight_decay)`` couples weight decay into
the gradient before the momentum buffer (g += wd*p; v = mu*v + g; p -= lr*v),
which is the JAX package's optax chain ``add_decayed_weights(wd)`` then
``sgd(schedule, momentum)``; ``tests/test_train.py::
test_sgd_matches_torch_oracle`` pins that the two agree. The learning rate
follows the reference's step decay, set on the optimizer before each update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import torch
from torch import nn

from radar_depth_tpu_torch.config import OptimConfig


def step_decay_schedule(cfg: OptimConfig,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = lr0 * factor ** (step // (decay_epochs * steps_per_epoch))."""
    decay_steps = max(1, cfg.lr_decay_epochs * steps_per_epoch)

    def schedule(step: int) -> float:
        return cfg.lr * cfg.lr_decay_factor ** (step // decay_steps)

    return schedule


@dataclasses.dataclass
class TrainState:
    """What a train step advances: the model (parameters and BN running
    statistics, updated in place), the optimizer (momentum buffers), the
    learning-rate schedule and the step count."""

    model: nn.Module
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    step: int = 0


def _host_copy(tree):
    """``tree`` with every tensor copied to the host: a snapshot that the
    next in-place update of the model does not reach."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def state_to_dict(state: TrainState) -> Dict[str, Any]:
    """{model, optimizer, step}: the model's state_dict (parameters and BN
    running statistics), the optimizer's (momentum buffers) and the step
    count, copied to the host before this returns (the train step updates
    the model in place, as the JAX step donates its buffers)."""
    return {"model": _host_copy(state.model.state_dict()),
            "optimizer": _host_copy(state.optimizer.state_dict()),
            "step": int(state.step)}


def load_state_dict(state: TrainState, payload: Mapping[str, Any]
                    ) -> TrainState:
    """Inverse of ``state_to_dict``, into ``state`` in place: strict on the
    model's keys and shapes; the optimizer state moves to the parameters'
    device."""
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def create_train_state(model: nn.Module, cfg: OptimConfig,
                       steps_per_epoch: int) -> TrainState:
    optimizer = torch.optim.SGD(model.parameters(), lr=cfg.lr,
                                momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay)
    return TrainState(model, optimizer,
                      step_decay_schedule(cfg, steps_per_epoch))
