"""Shared recipe plumbing: online augmentation, dataset evaluation and the
serving path.

Counterpart of ``unet_implementations_tpu/recipes/common.py``
(``check_grad_accum``, ``wrap_online_augment``, ``wrap_online_augment_clip``,
``evaluate_segmentation``, ``predict_segmentation``,
``evaluate_reconstruction``). The online wrappers augment each training batch
on the model's device (``data/augment.py``). In evaluation the forward and
the argmax run on the model's device; the nearest resize back to each image's
original size runs on the host with torch/cv2 floor index math, as the
reference eval protocol does. ``evaluate_segmentation`` writes
``evaluation_results.json`` with the reference's schema (and, with
``visualize_samples``, the figures of ``utils/visualize.py``),
``evaluate_reconstruction`` the JAX package's ``reconstruction_metrics.json``;
under a process group only rank 0 writes them.
``predict_segmentation(spatial=N)`` serves with each image's rows over the N
ranks of a space group (``parallel/spatial.py``), and from a serving
artifact (``serving/export.py``) it replays the exported program.
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unet_implementations_tpu_torch import default_device
from unet_implementations_tpu_torch.data.augment import (
    augment_and_normalize,
    augment_and_normalize_with_clip,
    policy_arrays,
)
from unet_implementations_tpu_torch.data.loader import PetDataset, batch_iterator
from unet_implementations_tpu_torch.ops.losses import psnr, ssim
from unet_implementations_tpu_torch.ops.metrics import SegmentationMetrics
from unet_implementations_tpu_torch.ops.normalize import normalize_image
from unet_implementations_tpu_torch.parallel.distributed import is_primary, world_size
from unet_implementations_tpu_torch.parallel.spatial import (
    SpatialGrid,
    create_mesh_dp_sp,
    gather_rows,
    rows_of,
)
from unet_implementations_tpu_torch.serving.export import (
    ARTIFACT_FORWARD,
    ServingModel,
    load_exported,
)
from unet_implementations_tpu_torch.training.checkpoint import model_file
from unet_implementations_tpu_torch.training.steps import to_device
from unet_implementations_tpu_torch.utils import visualize as V
from unet_implementations_tpu_torch.utils.visualize import colorize_mask, require_matplotlib

IMAGE_SIZE = 512
# Batches whose forward is dispatched before the oldest one's predictions
# are read back and resized on the host.
EVAL_RUN_AHEAD = 2


def augment_generator(seed: int, epoch: int, i: int, device, rank: int = 0) -> torch.Generator:
    """The generator of batch ``i`` of ``epoch``'s online augmentation, on
    ``device``, seeded from ``(seed + 7, epoch, i)`` mixed by numpy's
    ``SeedSequence``, and the ``rank`` of a data-parallel process after them
    (rank 0 draws what one process draws; JAX draws per image over the global
    batch, so the ranks' images must not share their draws). Both wrappers
    draw from it, so they apply the same transforms to the same batch. Under
    spatial partitioning ``rank`` is the data rank: the ranks of a space group
    augment the same whole images with the same draws (a homography spans
    the image), and each then keeps its rows (the train step's loss
    function does)."""
    mixed = np.random.SeedSequence([(seed + 7) & 0xFFFFFFFF, epoch & 0xFFFFFFFF,
                                    i & 0xFFFFFFFF] + ([rank] if rank else []))
    return torch.Generator(device=device).manual_seed(
        int(mixed.generate_state(1, np.uint64)[0]))


def _augmented(batches: Iterable[Dict], epoch: int, seed: int, device, policy, clip: bool,
               rank: int):
    device = torch.device(device)
    tables = policy_arrays(policy, device)
    augment = augment_and_normalize_with_clip if clip else augment_and_normalize
    for i, batch in enumerate(batches):
        out = augment(augment_generator(seed, epoch, i, device, rank),
                      to_device(batch["image"], device), to_device(batch["mask"], device),
                      policy=tables)
        yield batch, out


def wrap_online_augment(batches: Iterable[Dict], epoch: int, seed: int, device,
                        policy=None, rank: int = 0) -> Iterator[Dict]:
    """Augment each host batch on ``device`` (the model's): its uint8 pixels
    and masks cross through pinned memory (``to_device``), are augmented
    under ``policy`` (the built-in table by default; classes from the masks)
    and ImageNet-normalized there. Yields the batch with ``image`` float32
    and ``mask`` (its dtype kept) as tensors on ``device``; the train step's
    ``normalize_image`` passes the float image through. ``rank``: see
    ``augment_generator``."""
    for batch, (image, mask) in _augmented(batches, epoch, seed, device, policy, clip=False,
                                           rank=rank):
        yield dict(batch, image=image, mask=mask)


def wrap_online_augment_clip(batches: Iterable[Dict], epoch: int, seed: int, device,
                             extractor, policy=None, rank: int = 0) -> Iterator[Dict]:
    """``wrap_online_augment`` with live CLIP extraction: the frozen
    ``extractor`` embeds the 224² view of each AUGMENTED batch, so the
    features follow the pixels the model sees (tables cannot: the pixels
    change every epoch). Yields ``clip_features`` (B, dim) float32 on
    ``device``, a plain tensor that a training forward may save, and drops
    the loader's ``clip_image``."""
    for batch, (image, mask, clip_image) in _augmented(batches, epoch, seed, device, policy,
                                                       clip=True, rank=rank):
        out = dict(batch, image=image, mask=mask, clip_features=extractor(clip_image).clone())
        out.pop("clip_image", None)
        yield out


def check_grad_accum(batch_size: int, grad_accum: int, use_mesh: bool = False,
                     spatial: int = 1) -> None:
    """Fail fast on an indivisible accumulation split, before the datasets
    load (the train loops drop the last partial batch, so every training
    batch is ``batch_size``).

    With ``use_mesh`` under a process group of W ranks, ``batch_size`` (the
    global batch) must also split into W × ``grad_accum`` equal parts: each
    rank's stripe, then its microbatches (W / ``spatial`` stripes under
    spatial partitioning, whose space groups share their images). JAX only
    warns when the microbatch does not divide its device count, since XLA
    reshards; with one process per GPU an uneven split cannot be laid out,
    so this raises."""
    if grad_accum < 1:
        raise ValueError(f"--grad_accum must be >= 1, got {grad_accum}")
    if batch_size % grad_accum:
        raise ValueError(
            f"--grad_accum {grad_accum} does not divide --batch_size "
            f"{batch_size} into equal microbatches"
        )
    ranks = max(world_size() // spatial, 1) if use_mesh else 1
    if batch_size % (ranks * grad_accum):
        raise ValueError(
            f"--batch_size {batch_size} does not divide into {ranks} ranks x "
            f"{grad_accum} microbatches of equal size"
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
    visualize_samples: int = 0,
    probs_fn: Optional[Callable[[Dict], torch.Tensor]] = None,
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
    ``evaluation_results.json`` when ``output_dir`` is given; under a process
    group of several ranks only rank 0 writes (every rank returns the same
    results).

    ``visualize_samples > 0`` (with ``output_dir``) draws the first N
    batches into ``visualizations/``: ``predictions_batch{i}.png`` (the
    batch's triptychs), ``error_analysis_batch{i}.png`` (its first image)
    and, with ``probs_fn(batch) -> (B, H, W, C)`` softmax probabilities on
    the device, ``confidence_batch{i}.png``; then ``confusion_matrix.png``.
    The probability forward runs only for the batches drawn, dispatched with
    their predictions, and only the first image's (H, W, C) map comes back.
    The results do not depend on the figures.
    """
    write = output_dir is not None and is_primary()
    viz_dir = None
    if visualize_samples > 0 and write:
        require_matplotlib("evaluate's figures", "--visualize_samples 0")
        viz_dir = Path(output_dir) / "visualizations"
        viz_dir.mkdir(parents=True, exist_ok=True)
    metrics = SegmentationMetrics(num_classes=3, ignore_index=255)

    def dispatch(i, batch):
        preds = predict_fn(batch)
        # The second forward only for the batches whose confidence maps are
        # drawn; it stays on the device until ``process`` reads it.
        probs = (probs_fn(batch)[0] if probs_fn is not None and viz_dir is not None
                 and i < visualize_samples else None)
        return i, batch, preds, probs

    def process(i, batch, preds, probs):
        preds = preds.cpu().numpy() if isinstance(preds, torch.Tensor) else np.asarray(preds)
        for pred, mask, dims in zip(preds, batch["mask"], batch["original_dims"]):
            orig = (int(dims[0]), int(dims[1]))
            metrics.update(resize_nearest_np(pred.astype(np.uint8), orig),
                           resize_nearest_np(mask.astype(np.uint8), orig))
        if viz_dir is None or i >= visualize_samples:
            return
        image, masks = np.asarray(batch["image"]), batch["mask"]
        V.visualize_prediction_batch(image, masks, preds, viz_dir / f"predictions_batch{i}.png")
        V.visualize_error_analysis(image[0], preds[0], masks[0],
                                   viz_dir / f"error_analysis_batch{i}.png")
        if probs is not None:
            V.visualize_confidence_maps(image[0], probs.float().cpu().numpy(),
                                        viz_dir / f"confidence_batch{i}.png")

    pending = deque()
    batches = batch_iterator(dataset, batch_size, shuffle=False, num_threads=num_threads)
    for i, batch in enumerate(batches):
        pending.append(dispatch(i, batch))
        if len(pending) > EVAL_RUN_AHEAD:
            process(*pending.popleft())
    while pending:
        process(*pending.popleft())
    if viz_dir is not None:
        V.plot_confusion_matrix(metrics.cm, viz_dir / "confusion_matrix.png")

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

    if write:
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
    if output_dir is not None and is_primary():
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "reconstruction_metrics.json", "w") as f:
            json.dump(results, f, indent=4)
    return results


@torch.inference_mode()
def predict_arrays(
    model: torch.nn.Module | ServingModel,
    images_512: np.ndarray,
    original_dims: Sequence[Tuple[int, int]],
    grid: Optional[SpatialGrid] = None,
) -> List[np.ndarray]:
    """Masks for one batch of images.

    ``images_512``: (N, 512, 512, 3) uint8 RGB, already resized. The pixels
    cross to the model's device as uint8, are ImageNet-normalized there, run
    through ``model`` in its dtype (a ``ServingModel``: through the exported
    program, in its input dtype and static batch), and the argmax comes back.
    Each 512² mask is then nearest-resized to its ``original_dims`` entry
    (h, w). Returns uint8 masks with class ids {0, 1, 2}. Under a spatial
    ``grid`` (every rank calls it with the same images; a model, not an
    artifact) the model runs on this rank's rows, and the space group's rows
    of the argmax are gathered on each of its ranks.
    """
    if images_512.ndim != 4 or images_512.shape[-1] != 3 or images_512.dtype != np.uint8:
        raise ValueError(
            f"images_512 must be (N, H, W, 3) uint8, got {images_512.shape} {images_512.dtype}")
    if len(original_dims) != len(images_512):
        raise ValueError(f"{len(original_dims)} original sizes for {len(images_512)} images")
    served = isinstance(model, ServingModel)
    if served and grid is not None:
        raise ValueError("an exported artifact serves on one device, not on a spatial grid")
    device = model.device if served else next(model.parameters()).device
    pixels = torch.from_numpy(np.ascontiguousarray(images_512)).to(device, non_blocking=True)
    if grid is None:
        x = normalize_image(pixels)
        preds = torch.argmax(model.forward(x) if served else model(x), dim=-1)
    else:
        logits = model(normalize_image(rows_of(pixels, grid.context)), spatial=grid.context)
        preds = gather_rows(torch.argmax(logits, dim=-1), grid.context)
    preds = preds.to(torch.uint8).cpu().numpy()
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
    spatial: int = 0,
    verbose: bool = True,
) -> int:
    """Run the 6-stage UNet on an image file or a directory, from a
    checkpoint directory or a reference-schema ``.pth`` (``cli export_torch``
    of either package), or from a serving artifact (``cli export``, detected
    by its ``forward.pt2``): the artifact replays its exported program,
    without the model's code, in its input dtype (``dtype`` is not read) on
    the device it was exported on, and must take 512² images.

    Writes ``<stem>_mask.png`` (class ids {0,1,2} at the image's original
    resolution) and, with ``overlay``, ``<stem>_overlay.png`` (the coloured
    mask blended over the image). Runs on CUDA unless ``device`` names
    another device. Returns the number of images processed. The last batch
    may be smaller than ``batch_size``: eager PyTorch has no recompile to
    avoid, so it is not padded.

    ``spatial`` > 1 shards each image's rows over that many ranks of the
    process group (JAX's ``--spatial``: batch-1 latency over several cards),
    whose size must be a multiple of it. Every rank reads every image; the
    ranks of a space group share each forward, every space group runs the
    whole batch, and rank 0 writes the masks.
    """
    import cv2

    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    device = default_device(device)
    if (Path(model_path) / ARTIFACT_FORWARD).exists():
        if spatial > 1:
            raise ValueError("--spatial applies to training checkpoints; an AOT artifact "
                             "replays its exported forward on one device")
        model = load_exported(model_path, device)
        if model.meta["img_size"] != IMAGE_SIZE:
            raise ValueError(f"exported artifact is {model.meta['img_size']}px; predict "
                             f"expects a {IMAGE_SIZE}px export")
    else:
        from unet_implementations_tpu_torch.models import convert

        model = convert.load_reference_checkpoint(model_file(model_path), device=device,
                                                  dtype=dtype)
    grid = create_mesh_dp_sp(spatial, device=device) if spatial > 1 else None
    inputs = Path(inputs)
    files = sorted(
        p for p in ([inputs] if inputs.is_file() else inputs.iterdir())
        if p.suffix.lower() in (".jpg", ".jpeg", ".png")
    )
    output_dir = Path(output_dir)
    write = is_primary()
    if write:
        output_dir.mkdir(parents=True, exist_ok=True)

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
        masks = predict_arrays(model, np.stack(imgs), dims, grid)
        for (p, rgb), mask in zip(ok, masks):
            n += 1
            if not write:
                continue
            cv2.imwrite(str(output_dir / f"{p.stem}_mask.png"), mask)
            if overlay:
                blend = (0.6 * rgb + 0.4 * colorize_mask(mask)).astype(np.uint8)
                cv2.imwrite(str(output_dir / f"{p.stem}_overlay.png"),
                            cv2.cvtColor(blend, cv2.COLOR_RGB2BGR))
    if verbose and write:
        print(f"predicted {n} images -> {output_dir}")
    return n
