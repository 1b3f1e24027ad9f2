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
from typing import Callable

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


def create_train_state(model: nn.Module, cfg: OptimConfig,
                       steps_per_epoch: int) -> TrainState:
    optimizer = torch.optim.SGD(model.parameters(), lr=cfg.lr,
                                momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay)
    return TrainState(model, optimizer,
                      step_decay_schedule(cfg, steps_per_epoch))
