"""Shared recipe plumbing: dataset evaluation and the serving path.

Counterpart of ``unet_implementations_tpu/recipes/common.py``
(``check_grad_accum``, ``evaluate_segmentation``, ``predict_segmentation``,
``evaluate_reconstruction``; ``wrap_online_augment_clip`` raises until
on-device augmentation is ported). The forward and the argmax run on the model's
device; the nearest resize back to each image's original size runs on the
host with torch/cv2 floor index math, as the reference eval protocol does.
``evaluate_segmentation`` writes ``evaluation_results.json`` with the
reference's schema, ``evaluate_reconstruction`` the JAX package's
``reconstruction_metrics.json``.
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.ops.losses import psnr, ssim
from unet_implementations_tpu_torch.ops.metrics import SegmentationMetrics
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.training.steps import to_device
from unet_implementations_tpu_torch.utils.visualize import colorize_mask

IMAGE_SIZE = 512
# Batches whose forward is dispatched before the oldest one's predictions
# are read back and resized on the host.
EVAL_RUN_AHEAD = 2


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md queue 1 item {item})")


def wrap_online_augment_clip(batches, epoch: int, seed: int, extractor):
    """On-device augmentation with live CLIP extraction from the augmented
    pixels: not ported (it needs ``data/augment.py`` on the card)."""
    raise not_ported("wrap_online_augment_clip (--online_augment)", 4)


def check_grad_accum(batch_size: int, grad_accum: int) -> None:
    """Fail fast on an indivisible accumulation split, before the datasets
    load (the train loops drop the last partial batch, so every training
    batch is ``batch_size``)."""
    if grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {grad_accum}")
    if batch_size % grad_accum:
        raise ValueError(
            f"--grad_accum {grad_accum} does not divide --batch_size "
            f"{batch_size} into equal microbatches"
        )


def resize_nearest_np(arr: np.ndarray, size) -> np.ndarray:
    """Host-side nearest resize with torch/cv2 floor index semantics."""
    in_h, in_w = arr.shape[:2]
    out_h, out_w = int(size[0]), int(size[1])
    rows = np.clip(
        np.floor(np.arange(out_h, dtype=np.float64) * (in_h / out_h)).astype(np.int64),
        0, in_h - 1,
    )
    cols = np.clip(
        np.floor(np.arange(out_w, dtype=np.float64) * (in_w / out_w)).astype(np.int64),
        0, in_w - 1,
    )
    return arr[rows][:, cols]


def evaluate_segmentation(
    predict_fn: Callable[[Dict], torch.Tensor],
    dataset: PetDataset,
    batch_size: int = 32,
    output_dir: Optional[str | Path] = None,
    num_threads: int = 8,
    verbose: bool = True,
) -> Dict:
    """Dataset-level evaluation at original resolution.

    ``predict_fn(batch) -> (B, 512, 512)`` integer predictions (a tensor on
    the device, or numpy). Each prediction and its 512² mask are
    nearest-resized to the image's ``original_dims`` and added to one
    confusion matrix. The forwards run ahead of the host by
    ``EVAL_RUN_AHEAD`` batches, so the host's resizes overlap the device's
    work. Returns the reference's results dict and writes
    ``evaluation_results.json`` when ``output_dir`` is given.
    """
    metrics = SegmentationMetrics(num_classes=3, ignore_index=255)

    def process(batch, preds):
        preds = preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
        for pred, mask, dims in zip(preds, batch["mask"], batch["original_dims"]):
            orig = (int(dims[0]), int(dims[1]))
            metrics.update(resize_nearest_np(pred.astype(np.uint8), orig),
                           resize_nearest_np(mask.astype(np.uint8), orig))

    pending = deque()
    for batch in batch_iterator(dataset, batch_size, shuffle=False, num_threads=num_threads):
        pending.append((batch, predict_fn(batch)))
        if len(pending) > EVAL_RUN_AHEAD:
            process(*pending.popleft())
    while pending:
        process(*pending.popleft())

    def cls_result(c):
        return {
            "dice": metrics.compute_dice(c),
            "iou": metrics.compute_iou(c),
            "precision": metrics.compute_precision(c),
            "recall": metrics.compute_recall(c),
        }

    results = {
        "pixel_accuracy": metrics.compute_pixel_accuracy(),
        "mean_iou": metrics.compute_mean_iou(),
        "background": cls_result(0),
        "cat": cls_result(1),
        "dog": cls_result(2),
    }
    results["mean_foreground_dice"] = float(
        np.nanmean([results["cat"]["dice"], results["dog"]["dice"]]))

    if verbose:
        print(f"Pixel Accuracy: {results['pixel_accuracy']:.4f}")
        print(f"Mean IoU: {results['mean_iou']:.4f}")
        print(f"Mean Foreground Dice: {results['mean_foreground_dice']:.4f}")
        for name in ("background", "cat", "dog"):
            m = results[name]
            print(f"{name.capitalize():<10} | Precision: {m['precision']:.4f} | "
                  f"Recall: {m['recall']:.4f} | IoU: {m['iou']:.4f} | "
                  f"Dice: {m['dice']:.4f}")

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "evaluation_results.json", "w") as f:
            json.dump(results, f, indent=4)
    return results


def evaluate_reconstruction(
    recon_fn: Callable[[Dict], torch.Tensor],
    dataset: PetDataset,
    batch_size: int = 32,
    output_dir: Optional[str | Path] = None,
    num_threads: int = 8,
    verbose: bool = True,
) -> Dict:
    """Per-image MSE, PSNR and SSIM over a reconstruction-mode dataset, as
    ``reconstruction_metrics.json`` (``mse``, ``psnr``, ``ssim``,
    ``num_images``: each the mean over the images).

    ``recon_fn(batch) -> (B, H, W, 3)`` reconstructions on the device. The
    target (uint8 or [0, 1] float) crosses to the same device, and the three
    metrics are one device computation per batch; only their per-image
    scalars come back, with the forwards ``EVAL_RUN_AHEAD`` batches ahead of
    the host, as in ``evaluate_segmentation``."""
    @torch.inference_mode()
    def metrics(recon: torch.Tensor, batch: Dict) -> torch.Tensor:
        target = normalize_image(to_device(batch["target"], recon.device), mode="unit")
        diff = recon.to(torch.float32) - target.to(torch.float32)
        return torch.stack([torch.mean(diff * diff, dim=(1, 2, 3)), psnr(recon, target),
                            ssim(recon, target)])

    rows: List[np.ndarray] = []
    pending = deque()
    for batch in batch_iterator(dataset, batch_size, shuffle=False, num_threads=num_threads):
        pending.append(metrics(recon_fn(batch), batch))
        if len(pending) > EVAL_RUN_AHEAD:
            rows.append(pending.popleft().cpu().numpy())
    rows.extend(m.cpu().numpy() for m in pending)
    per_image = (np.concatenate(rows, axis=1) if rows else np.zeros((3, 0))).astype(np.float64)

    results = {
        "mse": float(np.mean(per_image[0])),
        "psnr": float(np.mean(per_image[1])),
        "ssim": float(np.mean(per_image[2])),
        "num_images": int(per_image.shape[1]),
    }
    if verbose:
        print(f"MSE: {results['mse']:.6f}  PSNR: {results['psnr']:.2f} dB  "
              f"SSIM: {results['ssim']:.4f}  (n={results['num_images']})")
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "reconstruction_metrics.json", "w") as f:
            json.dump(results, f, indent=4)
    return results


@torch.inference_mode()
def predict_arrays(
    model: torch.nn.Module,
    images_512: np.ndarray,
    original_dims: Sequence[Tuple[int, int]],
) -> List[np.ndarray]:
    """Masks for one batch of images.

    ``images_512``: (N, 512, 512, 3) uint8 RGB, already resized. The pixels
    cross to the model's device as uint8, are ImageNet-normalized there, run
    through ``model`` in its dtype, and the argmax comes back. Each
    512² mask is then nearest-resized to its ``original_dims`` entry (h, w).
    Returns uint8 masks with class ids {0, 1, 2}.
    """
    if images_512.ndim != 4 or images_512.shape[-1] != 3 or images_512.dtype != np.uint8:
        raise ValueError(
            f"images_512 must be (N, H, W, 3) uint8, got {images_512.shape} {images_512.dtype}")
    if len(original_dims) != len(images_512):
        raise ValueError(f"{len(original_dims)} original sizes for {len(images_512)} images")
    device = next(model.parameters()).device
    pixels = torch.from_numpy(np.ascontiguousarray(images_512)).to(device, non_blocking=True)
    logits = model(normalize_image(pixels))
    preds = torch.argmax(logits, dim=-1).to(torch.uint8).cpu().numpy()
    return [resize_nearest_np(pred, dims) for pred, dims in zip(preds, original_dims)]


def predict_segmentation(
    model_path: str | Path,
    inputs: str | Path,
    output_dir: str | Path,
    *,
    batch_size: int = 32,
    dtype: torch.dtype = torch.bfloat16,
    overlay: bool = True,
    device=None,
    verbose: bool = True,
) -> int:
    """Run the 6-stage UNet from a reference-schema ``.pth`` (``cli
    export_torch`` of the JAX package) on an image file or a directory.

    Writes ``<stem>_mask.png`` (class ids {0,1,2} at the image's original
    resolution) and, with ``overlay``, ``<stem>_overlay.png`` (the coloured
    mask blended over the image). Runs on CUDA unless ``device`` names
    another device. Returns the number of images processed. The last batch
    may be smaller than ``batch_size``: eager PyTorch has no recompile to
    avoid, so it is not padded.
    """
    import cv2

    from unet_implementations_tpu_torch.models import convert

    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    device = default_device(device)
    inputs = Path(inputs)
    files = sorted(
        p for p in ([inputs] if inputs.is_file() else inputs.iterdir())
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    model = convert.load_reference_checkpoint(model_path, device=device, dtype=dtype)

    n = 0
    for start in range(0, len(files), batch_size):
        imgs, dims, ok = [], [], []
        for p in files[start:start + batch_size]:
            raw = cv2.imread(str(p))
            if raw is None:
                if verbose:
                    print(f"skipping unreadable image: {p}")
                continue
            rgb = cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)
            dims.append(rgb.shape[:2])
            imgs.append(cv2.resize(rgb, (IMAGE_SIZE, IMAGE_SIZE),
                                   interpolation=cv2.INTER_LINEAR))
            ok.append((p, rgb))
        if not imgs:
            continue
        masks = predict_arrays(model, np.stack(imgs), dims)
        for (p, rgb), mask in zip(ok, masks):
            cv2.imwrite(str(output_dir / f"{p.stem}_mask.png"), mask)
            if overlay:
                blend = (0.6 * rgb + 0.4 * colorize_mask(mask)).astype(np.uint8)
                cv2.imwrite(str(output_dir / f"{p.stem}_overlay.png"),
                            cv2.cvtColor(blend, cv2.COLOR_RGB2BGR))
            n += 1
    if verbose:
        print(f"predicted {n} images -> {output_dir}")
    return n
