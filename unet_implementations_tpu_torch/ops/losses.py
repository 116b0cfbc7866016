"""Segmentation and reconstruction losses.

Counterpart of ``unet_implementations_tpu/ops/losses.py``. Segmentation:
Dice + class-weighted cross-entropy with border-ignore. Logits are NHWC, masks
integer (B, H, W) with the ignore label 255, and every reduction is float32
whatever the logits' dtype. The class weights are recomputed per batch from
inverse pixel frequency, in one-hot arithmetic (out-of-range labels, such as
255, one-hot to all zeros, as ``jax.nn.one_hot`` does).

Reconstruction (NHWC images in [0, 1]): MSE, per-image PSNR, Gaussian-window
SSIM, the perceptual (feature-space) MSE and their weighted sum, all in
float32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Reconstruction losses and metrics
# ---------------------------------------------------------------------------

# What ``perceptual_loss`` takes: one callable returning a dict of feature
# maps (``models/vgg.py::make_features_fn``, one trunk pass per branch), or a
# sequence of callables returning one map each.
FeatureFns = Union[Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                   Sequence[Callable[[torch.Tensor], torch.Tensor]]]


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements, in float32 (torch ``MSELoss``)."""
    diff = pred.to(torch.float32) - target.to(torch.float32)
    return torch.mean(diff * diff)


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR of NHWC input, (B,); each image's MSE clamped at 1e-10."""
    diff = pred.to(torch.float32) - target.to(torch.float32)
    mse = torch.mean(diff * diff, dim=tuple(range(1, pred.ndim)))
    mse = torch.clamp(mse, min=1e-10)
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _gaussian_1d(size: int, sigma: float, device=None) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _gaussian_window(size: int, sigma: float) -> torch.Tensor:
    """The (size, size) SSIM window: the outer product of the normalized 1-D
    Gaussian with itself."""
    g = _gaussian_1d(size, sigma)
    return torch.outer(g, g)


def _blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'same' blur of (..., H, W, C) float32 maps by the window
    ``outer(g, g)``, separably: along H, then along W, each tap a float32
    multiply and add.

    Elementwise on purpose: cuDNN runs float32 convs in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), whose 10-bit mantissa visibly
    perturbs SSIM's variance cancellation (E[x²] − E[x]²). JAX computes this
    blur at ``Precision.HIGHEST``; elementwise float32 is exact float32
    whatever the process's TF32 flags are."""
    pad = g.numel() // 2
    h, w = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, 0, 0, pad, pad))
    acc = g[0] * xp[..., 0:h, :, :]
    for k in range(1, g.numel()):
        acc = acc + g[k] * xp[..., k:k + h, :, :]
    xp = F.pad(acc, (0, 0, pad, pad))
    acc = g[0] * xp[..., :, 0:w, :]
    for k in range(1, g.numel()):
        acc = acc + g[k] * xp[..., :, k:k + w, :]
    return acc


def ssim(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11, sigma: float = 1.5,
         max_val: float = 1.0, size_average: bool = False) -> torch.Tensor:
    """Gaussian-window SSIM of NHWC input: a zero-padded depthwise blur,
    C1 = (0.01·max)², C2 = (0.03·max)². Per-image mean SSIM (B,), or with
    ``size_average`` a scalar mean over the whole map. Float32 throughout
    (``_blur`` says why the blur is elementwise)."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    g = _gaussian_1d(kernel_size, sigma, pred.device)
    # One blur over the five stacked maps.
    mu_p, mu_t, e_pp, e_tt, e_pt = _blur(
        torch.stack([pred, target, pred * pred, target * target, pred * target]), g)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    var_p = e_pp - mu_pp
    var_t = e_tt - mu_tt
    cov = e_pt - mu_pt
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    ssim_map = ((2 * mu_pt + c1) * (2 * cov + c2)) / ((mu_pp + mu_tt + c1) * (var_p + var_t + c2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=tuple(range(1, ssim_map.ndim)))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11) -> torch.Tensor:
    """``1 - SSIM`` averaged over the whole map."""
    return 1.0 - ssim(pred, target, kernel_size=kernel_size, size_average=True)


def perceptual_loss(pred: torch.Tensor, target: torch.Tensor, feature_fns: FeatureFns,
                    mean: Sequence[float] = (0.485, 0.456, 0.406),
                    std: Sequence[float] = (0.229, 0.224, 0.225)) -> torch.Tensor:
    """Feature-space MSE averaged over the extractor's taps, on
    ImageNet-normalized images. ``feature_fns`` is one callable returning a
    dict of feature maps, or a sequence of callables. The target branch
    carries no gradient (it runs under ``torch.no_grad``)."""
    m = torch.tensor(mean, dtype=torch.float32, device=pred.device)
    s = torch.tensor(std, dtype=torch.float32, device=pred.device)
    pred_n = (pred.to(torch.float32) - m) / s
    target_n = (target.to(torch.float32) - m) / s
    if callable(feature_fns):
        pf = feature_fns(pred_n)
        with torch.no_grad():
            tf = feature_fns(target_n)
        losses = [mse_loss(pf[k], tf[k]) for k in sorted(pf)]
        return sum(losses) / len(losses)
    loss = 0.0
    for fn in feature_fns:
        with torch.no_grad():
            tf = fn(target_n)
        loss = loss + mse_loss(fn(pred_n), tf)
    return loss / len(feature_fns)


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor, mse_weight: float = 1.0,
                        perceptual_weight: float = 0.0, ssim_weight: float = 0.0,
                        feature_fns: Optional[FeatureFns] = None) -> torch.Tensor:
    """``mse_w·MSE + perc_w·Perceptual + ssim_w·(1 − SSIM)``; the perceptual
    term needs ``feature_fns`` and is skipped without them, as in JAX."""
    total = mse_weight * mse_loss(pred, target)
    if perceptual_weight > 0 and feature_fns:
        total = total + perceptual_weight * perceptual_loss(pred, target, feature_fns)
    if ssim_weight > 0:
        total = total + ssim_weight * ssim_loss(pred, target)
    return total
