"""The visualization suite: host numpy arrays and matplotlib figures.

Counterpart of ``unet_implementations_tpu/utils/visualize.py``, function for
function: mask colouring and prediction triptychs, per-class confidence maps,
the TP/FP/FN error map, confusion matrices, class-distribution bars, the
autoencoder's original | reconstruction | error strips and the training
curves of either CSV schema. The arrays (``denormalize_image``,
``colorize_mask``, ``error_analysis_map``, ``create_comparison_image``) are
numpy on the host, as in JAX; the drawers save PNGs with the headless Agg
backend. matplotlib is imported inside the functions that need it, so
importing this module does not need it (the card machine may lack it).
Colours follow the reference: class 0 black, 1 red, 2 green, border 255
black.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from unet_implementations_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD

CLASS_COLORS = np.array(
    [[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8
)  # background, cat, dog


def require_matplotlib(what: str, flag: Optional[str] = None) -> None:
    """Raise ``ImportError`` when matplotlib cannot be imported, saying that
    ``what`` needs it and, if given, the ``flag`` that does without it."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        instead = f"; install it, or pass {flag}" if flag else ""
        raise ImportError(f"{what} needs matplotlib, which cannot be imported "
                          f"({e}){instead}") from e


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def denormalize_image(image: np.ndarray) -> np.ndarray:
    """ImageNet-normalized float image → uint8 RGB."""
    img = image * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def colorize_mask(mask: np.ndarray) -> np.ndarray:
    """{0→black, 1→red, 2→green}, 255 black."""
    out = np.zeros((*mask.shape, 3), np.uint8)
    for cls in (1, 2):
        out[mask == cls] = CLASS_COLORS[cls]
    return out


def visualize_prediction_batch(
    images: np.ndarray,       # (B,H,W,3) normalized
    masks: np.ndarray,        # (B,H,W)
    preds: np.ndarray,        # (B,H,W)
    save_path: str | Path,
    max_samples: int = 4,
) -> None:
    """Image / ground truth / prediction triptychs."""
    plt = _plt()
    n = min(len(images), max_samples)
    fig, axes = plt.subplots(n, 3, figsize=(12, 4 * n), squeeze=False)
    for i in range(n):
        axes[i][0].imshow(denormalize_image(images[i]))
        axes[i][0].set_title("Image")
        axes[i][1].imshow(colorize_mask(masks[i]))
        axes[i][1].set_title("Ground Truth")
        axes[i][2].imshow(colorize_mask(preds[i]))
        axes[i][2].set_title("Prediction")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def visualize_confidence_maps(
    image: np.ndarray,        # (H,W,3) normalized
    probs: np.ndarray,        # (H,W,C) softmax
    save_path: str | Path,
    class_names: Sequence[str] = ("Background", "Cat", "Dog"),
) -> None:
    """Per-class softmax heatmaps with colorbars."""
    plt = _plt()
    c = probs.shape[-1]
    fig, axes = plt.subplots(1, c + 1, figsize=(4 * (c + 1), 4))
    axes[0].imshow(denormalize_image(image))
    axes[0].set_title("Image")
    axes[0].axis("off")
    for i in range(c):
        im = axes[i + 1].imshow(probs[..., i], cmap="jet", vmin=0, vmax=1)
        axes[i + 1].set_title(f"{class_names[i]} confidence")
        axes[i + 1].axis("off")
        fig.colorbar(im, ax=axes[i + 1], fraction=0.046)
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def error_analysis_map(
    pred: np.ndarray, target: np.ndarray, ignore_index: int = 255
) -> np.ndarray:
    """Colour-coded error map: green = correct foreground, blue = FN, red =
    FP, yellow = wrong foreground class, black elsewhere."""
    h, w = pred.shape
    out = np.zeros((h, w, 3), np.uint8)
    valid = target != ignore_index
    fg_t = (target > 0) & valid
    fg_p = (pred > 0) & valid
    correct = fg_t & fg_p & (pred == target)
    fn = fg_t & ~fg_p
    fp = ~fg_t & fg_p
    wrong = fg_t & fg_p & (pred != target)
    out[correct] = [0, 255, 0]
    out[fn] = [0, 0, 255]
    out[fp] = [255, 0, 0]
    out[wrong] = [255, 255, 0]
    return out


def visualize_error_analysis(
    image: np.ndarray, pred: np.ndarray, target: np.ndarray,
    save_path: str | Path, alpha: float = 0.5,
) -> None:
    plt = _plt()
    base = denormalize_image(image).astype(np.float32)
    err = error_analysis_map(pred, target).astype(np.float32)
    blend = np.clip(base * (1 - alpha) + err * alpha, 0, 255).astype(np.uint8)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(blend)
    ax.set_title("Error analysis (green=correct fg, blue=FN, red=FP, yellow=wrong class)")
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_confusion_matrix(
    cm: np.ndarray,
    save_path: str | Path,
    class_names: Sequence[str] = ("Background", "Cat", "Dog"),
) -> None:
    """Raw and row-normalized confusion matrices."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    for ax, data, title, fmt in [
        (axes[0], cm, "Confusion matrix", "{:.0f}"),
        (axes[1], norm, "Row-normalized", "{:.3f}"),
    ]:
        im = ax.imshow(data, cmap="Blues")
        ax.set_xticks(range(len(class_names)), class_names)
        ax.set_yticks(range(len(class_names)), class_names)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(title)
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                ax.text(j, i, fmt.format(data[i, j]), ha="center", va="center",
                        color="black" if data[i, j] < data.max() * 0.6 else "white")
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_class_distribution(
    masks: List[np.ndarray],
    save_path: str | Path,
    class_names: Sequence[str] = ("Background", "Cat", "Dog"),
    ignore_index: int = 255,
) -> Dict[str, float]:
    """Pixel-share bar chart over a set of masks; returns the shares."""
    plt = _plt()
    counts = np.zeros(len(class_names))
    for m in masks:
        valid = m != ignore_index
        for c in range(len(class_names)):
            counts[c] += ((m == c) & valid).sum()
    shares = counts / max(counts.sum(), 1)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(class_names, shares, color=["gray", "tab:red", "tab:green"])
    ax.set_ylabel("Pixel share")
    ax.set_title("Class distribution")
    for i, s in enumerate(shares):
        ax.text(i, s, f"{s:.3f}", ha="center", va="bottom")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
    return {n: float(s) for n, s in zip(class_names, shares)}


def create_comparison_image(
    original: np.ndarray, recon: np.ndarray
) -> np.ndarray:
    """original | reconstruction | JET error map, side by side, uint8."""
    import matplotlib.cm as cm

    o = np.clip(original, 0, 1)
    r = np.clip(recon, 0, 1)
    err = np.abs(o - r).mean(axis=-1)
    err_norm = err / max(err.max(), 1e-6)
    err_rgb = cm.jet(err_norm)[..., :3]
    strip = np.concatenate([o, r, err_rgb], axis=1)
    return (strip * 255).astype(np.uint8)


def save_comparison_grid(
    originals: np.ndarray, recons: np.ndarray, save_path: str | Path,
    max_samples: int = 8,
) -> None:
    plt = _plt()
    n = min(len(originals), max_samples)
    fig, axes = plt.subplots(n, 1, figsize=(12, 4 * n), squeeze=False)
    for i in range(n):
        axes[i][0].imshow(create_comparison_image(originals[i], recons[i]))
        axes[i][0].set_title("original | reconstruction | error")
        axes[i][0].axis("off")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def plot_training_curves(
    csv_path: str | Path, save_path: str | Path
) -> None:
    """Loss, metric and learning-rate curves from ``training_log.csv``
    (the segmentation or the autoencoder schema)."""
    plt = _plt()
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return
    epochs = [int(r["epoch"]) for r in rows]
    cols = [c for c in rows[0] if c not in ("epoch", "epoch_time")]
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    axes[0].plot(epochs, [float(r["train_loss"]) for r in rows], label="train")
    axes[0].plot(epochs, [float(r["val_loss"]) for r in rows], label="val")
    axes[0].set_title("Loss")
    axes[0].legend()
    metric_cols = [c for c in cols if c.startswith(("dice_", "val_mse", "val_psnr"))]
    for c in metric_cols:
        axes[1].plot(epochs, [float(r[c]) for r in rows], label=c)
    axes[1].set_title("Metrics")
    axes[1].legend(fontsize=7)
    axes[2].plot(epochs, [float(r["learning_rate"]) for r in rows])
    axes[2].set_title("Learning rate")
    for ax in axes:
        ax.set_xlabel("epoch")
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)
