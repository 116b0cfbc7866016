"""Segmentation metrics from one confusion matrix.

Counterpart of ``unet_implementations_tpu/ops/metrics.py``. Every per-class
statistic derives from a (C, C) confusion matrix over valid (non-ignore)
pixels, rows the target and columns the prediction:

    TP_c = cm[c, c]
    FN_c = sum(cm[c, :]) - cm[c, c]
    FP_c = sum(cm[:, c]) - cm[c, c]
    pixel_accuracy = trace(cm) / sum(cm)

``confusion_matrix`` and ``batch_dice_scores`` run on the tensors' device;
``SegmentationMetrics`` accumulates on the host in numpy, with the reference
API (reset / update / compute_* / get_all_metrics), NaN where a denominator
is zero, and NaN-skipping means.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

IGNORE_INDEX = 255


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int = 3,
                     ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """(num_classes, num_classes) float32 counts, rows target, columns pred.

    Ignore-labelled target pixels, and target labels outside [0, C), add
    nothing; predictions are clipped into [0, C)."""
    pred = pred.reshape(-1).to(torch.int64)
    target = target.reshape(-1).to(torch.int64)
    valid = (target != ignore_index) & (target >= 0) & (target < num_classes)
    t = torch.where(valid, target, torch.zeros_like(target))
    p = torch.clamp(pred, 0, num_classes - 1)
    counts = torch.bincount(t * num_classes + p, weights=valid.to(torch.float32),
                            minlength=num_classes * num_classes)
    return counts.to(torch.float32).reshape(num_classes, num_classes)


def metrics_from_confusion(cm) -> Dict[str, np.ndarray]:
    """Per-class statistics of a confusion matrix (host-side numpy)."""
    cm = np.asarray(cm, dtype=np.float64)
    tp = np.diag(cm)
    return {"tp": tp, "fp": cm.sum(axis=0) - tp, "fn": cm.sum(axis=1) - tp,
            "total": cm.sum(), "correct": tp.sum()}


def _nan_div(num: float, den: float) -> float:
    return float(num / den) if den > 0 else float("nan")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class SegmentationMetrics:
    """Dataset-level accumulator with the reference's API."""

    def __init__(self, num_classes: int, ignore_index: int = IGNORE_INDEX):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self.cm = np.zeros((self.num_classes, self.num_classes), dtype=np.float64)

    def update(self, pred, target) -> None:
        """Accumulate one prediction/target pair (any matching shape; numpy
        or tensors). Target labels outside [0, C) other than the ignore label
        have no row and are dropped, as in ``confusion_matrix``."""
        pred = _host(pred).reshape(-1).astype(np.int64)
        target = _host(target).reshape(-1).astype(np.int64)
        valid = (target != self.ignore_index) & (target >= 0) & (target < self.num_classes)
        idx = target[valid] * self.num_classes + np.clip(pred[valid], 0, self.num_classes - 1)
        self.cm += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def update_confusion(self, cm) -> None:
        """Accumulate a confusion matrix computed on the device."""
        self.cm += _host(cm).astype(np.float64)

    def compute_pixel_accuracy(self) -> float:
        return _nan_div(np.diag(self.cm).sum(), self.cm.sum())

    def compute_iou(self, cls: int) -> float:
        tp = self.cm[cls, cls]
        return _nan_div(tp, self.cm[cls, :].sum() + self.cm[:, cls].sum() - tp)

    def compute_mean_iou(self) -> float:
        vals = [v for v in (self.compute_iou(c) for c in range(self.num_classes))
                if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")

    def compute_dice(self, cls: int) -> float:
        return _nan_div(2.0 * self.cm[cls, cls], self.cm[cls, :].sum() + self.cm[:, cls].sum())

    def compute_mean_dice(self) -> float:
        vals = [v for v in (self.compute_dice(c) for c in range(self.num_classes))
                if not np.isnan(v)]
        return float(np.mean(vals)) if vals else float("nan")

    def compute_precision(self, cls: int) -> float:
        return _nan_div(self.cm[cls, cls], self.cm[:, cls].sum())

    def compute_recall(self, cls: int) -> float:
        return _nan_div(self.cm[cls, cls], self.cm[cls, :].sum())

    def compute_f1_score(self, cls: int) -> float:
        return self.compute_dice(cls)

    def get_all_metrics(self) -> Dict:
        results = {"pixel_accuracy": self.compute_pixel_accuracy(),
                   "mean_iou": self.compute_mean_iou(),
                   "mean_dice": self.compute_mean_dice(),
                   "class_metrics": {}}
        for cls in range(self.num_classes):
            results["class_metrics"][f"class_{cls}"] = {
                "iou": self.compute_iou(cls), "dice": self.compute_dice(cls),
                "precision": self.compute_precision(cls), "recall": self.compute_recall(cls),
                "f1_score": self.compute_f1_score(cls)}
        return results


def compute_dice(pred, target, cls: int, ignore_index: int = IGNORE_INDEX) -> float:
    m = SegmentationMetrics(max(cls + 1, 3), ignore_index)
    m.update(pred, target)
    return m.compute_dice(cls)


def compute_iou(pred, target, cls: int, ignore_index: int = IGNORE_INDEX) -> float:
    m = SegmentationMetrics(max(cls + 1, 3), ignore_index)
    m.update(pred, target)
    return m.compute_iou(cls)


def compute_pixel_accuracy(pred, target, ignore_index: int = IGNORE_INDEX) -> float:
    m = SegmentationMetrics(3, ignore_index)
    m.update(pred, target)
    return m.compute_pixel_accuracy()


def batch_dice_scores(pred: torch.Tensor, mask: torch.Tensor,
                      ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Per-class hard Dice over one batch, the validation-loop protocol:
    ``2·I / (U + 1e-5)`` over the whole batch with 255 masked out, and 1.0
    where the union is empty. Returns (3,) float32 [bg, cat, dog]."""
    valid = (mask != ignore_index).to(torch.float32)
    scores = []
    for cls in range(3):
        p = (pred == cls).to(torch.float32) * valid
        t = (mask == cls).to(torch.float32) * valid
        inter = (p * t).sum()
        union = p.sum() + t.sum()
        scores.append(torch.where(union > 0, 2.0 * inter / (union + 1e-5),
                                  torch.ones((), device=union.device)))
    return torch.stack(scores)
