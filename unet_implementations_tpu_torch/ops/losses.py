"""Segmentation losses: Dice + class-weighted cross-entropy with border-ignore.

Counterpart of the segmentation part of ``unet_implementations_tpu/ops/
losses.py`` (its lines 32-139). Logits are NHWC, masks integer (B, H, W) with
the ignore label 255, and every reduction is float32 whatever the logits'
dtype. The class weights are recomputed per batch from inverse pixel
frequency, in one-hot arithmetic (out-of-range labels, such as 255, one-hot to
all zeros, as ``jax.nn.one_hot`` does). The reconstruction losses come with
their own slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from unet_implementations_tpu_torch.ops.resize import resize_bilinear

IGNORE_INDEX = 255


def _valid_mask(mask: torch.Tensor, ignore_index: int) -> torch.Tensor:
    return (mask != ignore_index).to(torch.float32)


def _one_hot(mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot over a trailing axis; labels outside [0, C) give zeros."""
    classes = torch.arange(num_classes, device=mask.device)
    return (mask.unsqueeze(-1) == classes).to(torch.float32)


def compute_class_weights(mask: torch.Tensor, num_classes: int = 3,
                          ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Inverse-frequency class weights of a batch of masks: ``w_c = valid
    pixels / count_c`` with zero counts clamped to 1, normalized so that
    ``sum(w) == num_classes``."""
    valid = _valid_mask(mask, ignore_index)
    onehot = _one_hot(mask, num_classes)
    counts = (onehot * valid.unsqueeze(-1)).sum(dim=tuple(range(mask.ndim)))
    total = valid.sum()
    counts = torch.where(counts == 0, torch.ones_like(counts), counts)
    weights = total / counts
    return weights * (num_classes / weights.sum())


def weighted_cross_entropy(logits: torch.Tensor, mask: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Class-weighted CE with an ignore label, torch ``CrossEntropyLoss``
    semantics: ``sum_i w[y_i]·nll_i / sum_i w[y_i]`` over valid pixels (the
    plain mean when ``class_weights`` is None)."""
    num_classes = logits.shape[-1]
    logits = logits.to(torch.float32)
    valid = _valid_mask(mask, ignore_index)
    onehot = _one_hot(mask, num_classes)
    nll = -(torch.log_softmax(logits, dim=-1) * onehot).sum(dim=-1)
    if class_weights is None:
        pixel_w = valid
    else:
        pixel_w = (onehot * class_weights.to(torch.float32)).sum(dim=-1) * valid
    denom = torch.clamp(pixel_w.sum(), min=1e-12)
    return (nll * pixel_w).sum() / denom


def soft_dice_loss(logits: torch.Tensor, mask: torch.Tensor, ignore_index: int = IGNORE_INDEX,
                   smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice over all classes, border masked out: per class c and image
    b, ``dice = (2·I + s) / (U + s)`` with ``I = sum(p_c·t_c)`` and ``U =
    sum(p_c) + sum(t_c)`` over valid pixels; the loss is
    ``mean_c(1 − mean_b(dice))``."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    valid = _valid_mask(mask, ignore_index).unsqueeze(-1)
    onehot = _one_hot(mask, num_classes) * valid
    probs = probs * valid
    spatial = tuple(range(1, probs.ndim - 1))
    intersection = (probs * onehot).sum(dim=spatial)
    union = probs.sum(dim=spatial) + onehot.sum(dim=spatial)
    dice = (2.0 * intersection + smooth) / (union + smooth)
    return (1.0 - dice.mean(dim=0)).mean()


def segmentation_loss(logits: torch.Tensor, mask: torch.Tensor, weight_ce: float = 1.0,
                      weight_dice: float = 1.0, class_weights: Optional[torch.Tensor] = None,
                      dynamic_weights: bool = True, ignore_index: int = IGNORE_INDEX,
                      smooth: float = 1e-5) -> torch.Tensor:
    """``weight_ce·CE + weight_dice·Dice``. With ``dynamic_weights`` (and no
    ``class_weights``) the CE weights are recomputed from this batch; given
    ``class_weights`` are static; neither gives unweighted CE. Logits at
    another size than the mask are resized to it bilinearly first."""
    if tuple(logits.shape[1:3]) != tuple(mask.shape[1:3]):
        logits = resize_bilinear(logits, tuple(mask.shape[1:3]))
    if dynamic_weights and class_weights is None:
        class_weights = compute_class_weights(mask, logits.shape[-1], ignore_index)
    ce = weighted_cross_entropy(logits, mask, class_weights, ignore_index)
    dice = soft_dice_loss(logits, mask, ignore_index, smooth)
    return weight_ce * ce + weight_dice * dice
