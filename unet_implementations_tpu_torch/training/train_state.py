"""Optimizers and learning-rate schedules.

Counterpart of ``unet_implementations_tpu/training/train_state.py``. The JAX
state is an immutable pytree with optax chains; the port uses PyTorch's
idiom, a module and a ``torch.optim`` optimizer updated in place:

- ``sgd_nesterov``: ``SGD(lr, momentum, weight_decay, nesterov=True)``. The
  L2 term is added to the gradient, then the Nesterov momentum, then −lr:
  optax's ``add_decayed_weights`` → ``trace(nesterov=True)`` →
  ``scale_by_learning_rate`` step for step (torch's first momentum buffer is
  the gradient itself, as optax's trace from zeros).
- ``adam_l2``: ``Adam`` with an L2 ``weight_decay`` added to the gradient
  before the moments (not AdamW).
- ``poly_lr`` and ``cosine_lr``: per-epoch schedules as plain functions;
  ``set_learning_rate`` writes the value into every parameter group.
- ``with_frozen``: the transfer recipe's frozen encoder, as
  ``requires_grad_(False)`` on named submodules. A parameter without a
  gradient is skipped by the optimizer, weight decay included, as optax's
  ``set_to_zero`` leaves it.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch
from torch import nn


def sgd_nesterov(params: Iterable, learning_rate: float = 5e-3, weight_decay: float = 1e-4,
                 momentum: float = 0.99) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay, nesterov=True)


def adam_l2(params: Iterable, learning_rate: float = 1e-3,
            weight_decay: float = 1e-5) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def with_frozen(model: nn.Module, frozen_prefixes: Sequence[str]) -> nn.Module:
    """Freeze the named submodules (``model.get_submodule`` names, e.g.
    ``encoder_stages``) in place; returns ``model``."""
    for name in frozen_prefixes:
        model.get_submodule(name).requires_grad_(False)
    return model


def poly_lr(base_lr: float, max_epochs: int, power: float = 0.9) -> Callable[[int], float]:
    """nnU-Net polynomial decay ``base·(1 − epoch/max)^power``."""
    def schedule(epoch: int) -> float:
        return base_lr * (1.0 - epoch / max_epochs) ** power

    return schedule


def cosine_lr(base_lr: float, t_max: int, eta_min: float = 1e-6) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR(T_max, eta_min)`` as a function of the epoch."""
    def schedule(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2

    return schedule


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
