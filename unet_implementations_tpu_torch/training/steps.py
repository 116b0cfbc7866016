"""The segmentation and reconstruction train and eval steps.

Counterpart of ``unet_implementations_tpu/training/steps.py`` (its lines
29-97 and 184-261). JAX jits a pure ``(state, batch, rng) -> (state, loss)``;
the port runs eagerly and updates the model and its optimizer in place.

A batch is ``{"image": (B, H, W, 3) uint8 or float, "mask": (B, H, W) int}``,
numpy arrays or tensors, and with ``use_clip`` also ``"clip_features"``
(B, clip_dim), the CLIP embeddings the model fuses at its bottleneck
(``recipes/clip_unet.py`` attaches them). It moves to the model's device
(through pinned memory, ``to_device``), where uint8 pixels are
ImageNet-normalized in the step (``ops.normalize``), as in JAX.

The train step runs the forward in training mode, with channel dropout drawn
from the ``torch.Generator`` it is given (on the model's device), then
``segmentation_loss`` with per-batch class weights, ``backward()`` and
``optimizer.step()``: the forward launches K1 and K2, the backward K1's
backward kernel (K1bwd); only K2's transpose runs in plain torch. The eval
step runs in eval mode under ``torch.inference_mode`` (so in the s2d layout
the fused block tail, K3, runs) and returns the loss, the per-class batch
Dice, the argmax predictions and a confusion matrix.

The reconstruction steps take ``{"image", "target"}`` (uint8, or float in
[0, 1]), scale uint8 to [0, 1] on the device (``mode="unit"``, no ImageNet
statistics), and train on the MSE, or on ``loss_fn(recon, target)`` (the
composite loss of ``recipes/ae_recon.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from unet_implementations_tpu_torch.ops.losses import mse_loss, psnr, segmentation_loss
from unet_implementations_tpu_torch.ops.metrics import batch_dice_scores, confusion_matrix
from unet_implementations_tpu_torch.ops.normalize import normalize_image


def to_device(value, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) on ``device``. From the host to a CUDA
    device it goes through page-locked memory: a copy from pageable memory
    holds the stream for the whole staged transfer, so the device would wait
    for it on every batch; from pinned memory the copy runs at the link's
    rate and the host does not wait."""
    tensor = torch.as_tensor(value)
    if device.type == "cuda" and tensor.device.type == "cpu":
        tensor = tensor.pin_memory()
    return tensor.to(device, non_blocking=True)


def _on_device(batch: Dict, device: torch.device):
    return normalize_image(to_device(batch["image"], device)), to_device(batch["mask"], device)


def _clip_kwargs(batch: Dict, device: torch.device, use_clip: bool) -> Dict:
    """The model's ``clip_features`` keyword: the batch's features on the
    device with ``use_clip`` (None when the batch has none, as JAX's
    ``batch.get``), else nothing."""
    if not use_clip:
        return {}
    features = batch.get("clip_features")
    return {"clip_features": None if features is None else to_device(features, device)}


def make_segmentation_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    dynamic_weights: bool = True,
    static_weights: Optional[torch.Tensor] = None,
    use_clip: bool = False,
) -> Callable:
    """``step(batch, generator) -> loss`` (a float32 scalar tensor on the
    model's device, detached): one forward, backward and optimizer update of
    ``model`` in place. ``static_weights`` (C,) replaces the per-batch class
    weights; ``use_clip`` feeds the batch's ``clip_features`` to the model."""
    device = next(model.parameters()).device

    def step(batch: Dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        model.train()
        image, mask = _on_device(batch, device)
        optimizer.zero_grad(set_to_none=True)
        logits = model(image, generator=generator, **_clip_kwargs(batch, device, use_clip))
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
    use_clip: bool = False,
) -> Callable:
    """``step(batch) -> {"loss", "dice" (3,), "preds" (B, H, W) int32,
    "confusion" (3, 3)}``, all on the model's device; ``use_clip`` as in the
    train step."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        image, mask = _on_device(batch, device)
        logits = model(image, **_clip_kwargs(batch, device, use_clip))
        loss = segmentation_loss(logits, mask, weight_ce=weight_ce, weight_dice=weight_dice,
                                 class_weights=static_weights,
                                 dynamic_weights=dynamic_weights and static_weights is None)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        return {"loss": loss, "dice": batch_dice_scores(preds, mask), "preds": preds,
                "confusion": confusion_matrix(preds, mask)}

    return step


def _recon_on_device(batch: Dict, device: torch.device):
    return (normalize_image(to_device(batch["image"], device), mode="unit"),
            normalize_image(to_device(batch["target"], device), mode="unit"))


def make_reconstruction_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = mse_loss,
) -> Callable:
    """``step(batch, generator) -> loss`` (a detached float32 scalar on the
    model's device): a training forward with channel dropout from
    ``generator``, ``loss_fn(recon, target)`` (plain MSE by default, the
    reference's trained objective), backward and optimizer update in
    place."""
    device = next(model.parameters()).device

    def step(batch: Dict, generator: Optional[torch.Generator]) -> torch.Tensor:
        model.train()
        image, target = _recon_on_device(batch, device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(image, generator=generator), target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_reconstruction_eval_step(model: nn.Module) -> Callable:
    """``step(batch) -> {"loss" (the MSE), "mse" (B,), "psnr" (B,), "recon"
    (B, H, W, 3) float32}``, all on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        image, target = _recon_on_device(batch, device)
        recon = model(image)
        diff = recon.to(torch.float32) - target.to(torch.float32)
        return {"loss": mse_loss(recon, target), "mse": torch.mean(diff * diff, dim=(1, 2, 3)),
                "psnr": psnr(recon, target), "recon": recon}

    return step
