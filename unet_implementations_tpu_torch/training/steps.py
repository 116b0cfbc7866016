"""The segmentation train and eval steps.

Counterpart of ``unet_implementations_tpu/training/steps.py`` (its lines
29-97 and 184-219). JAX jits a pure ``(state, batch, rng) -> (state, loss)``;
the port runs eagerly and updates the model and its optimizer in place.

A batch is ``{"image": (B, H, W, 3) uint8 or float, "mask": (B, H, W) int}``,
numpy arrays or tensors; it moves to the model's device, where uint8 pixels
are ImageNet-normalized in the step (``ops.normalize``), as in JAX.

The train step runs the forward in training mode, with channel dropout drawn
from the ``torch.Generator`` it is given (on the model's device), then
``segmentation_loss`` with per-batch class weights, ``backward()`` and
``optimizer.step()``: the forward launches K1 and K2 and their backward runs
in plain torch. The eval step runs in eval mode under ``torch.inference_mode``
(so in the s2d layout the fused block tail, K3, runs) and returns the loss,
the per-class batch Dice, the argmax predictions and a confusion matrix.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from unet_implementations_tpu_torch.ops.losses import segmentation_loss
from unet_implementations_tpu_torch.ops.metrics import batch_dice_scores, confusion_matrix
from unet_implementations_tpu_torch.ops.normalize import normalize_image


def _on_device(batch: Dict, device: torch.device):
    image = torch.as_tensor(batch["image"]).to(device, non_blocking=True)
    mask = torch.as_tensor(batch["mask"]).to(device, non_blocking=True)
    return normalize_image(image), mask


def make_segmentation_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
) -> Callable:
    """``step(batch, generator) -> loss`` (a float32 scalar tensor on the
    model's device, detached): one forward, backward and optimizer update of
    ``model`` in place. ``static_weights`` (C,) replaces the per-batch class
    weights."""
    device = next(model.parameters()).device

    def step(batch: Dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        model.train()
        image, mask = _on_device(batch, device)
        optimizer.zero_grad(set_to_none=True)
        logits = model(image, generator=generator)
        loss = segmentation_loss(logits, mask, weight_ce=weight_ce, weight_dice=weight_dice,
                                 class_weights=static_weights,
                                 dynamic_weights=dynamic_weights and static_weights is None)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_segmentation_eval_step(
    model: nn.Module,
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
) -> Callable:
    """``step(batch) -> {"loss", "dice" (3,), "preds" (B, H, W) int32,
    "confusion" (3, 3)}``, all on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        image, mask = _on_device(batch, device)
        logits = model(image)
        loss = segmentation_loss(logits, mask, weight_ce=weight_ce, weight_dice=weight_dice,
                                 class_weights=static_weights,
                                 dynamic_weights=dynamic_weights and static_weights is None)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "dice": batch_dice_scores(preds, mask), "preds": preds,
                "confusion": confusion_matrix(preds, mask)}

    return step
