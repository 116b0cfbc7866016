"""Synthetic pet-like data for smoke tests and benchmarks (numpy only).

The port's own copy of ``unet_implementations_tpu/data/synthetic.py``: an
elliptical "pet" (class 1 = cat or 2 = dog) on a textured background, with a
255 border ring around it, the Oxford-IIIT Pet trimap format ({0, 1, 2, 255}
masks, ImageNet-normalized RGB). The same seed gives the same arrays as the
JAX package's (its segmentation batches; the CLIP features and the
reconstruction targets come with their slices). ``as_uint8`` turns a batch
into the raw uint8 pixels the loader feeds the in-step normalization.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from unet_implementations_tpu_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD


def synthetic_sample(rng: np.random.Generator, size: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """One (image (H, W, 3) normalized float32, mask (H, W) int32) pair."""
    cls = int(rng.integers(1, 3))  # 1 = cat, 2 = dog
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    ry, rx = rng.uniform(0.15, 0.3, 2) * size
    dist = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
    inside = dist <= 1.0
    border = (dist > 1.0) & (dist <= 1.25)

    mask = np.zeros((size, size), np.int32)
    mask[inside] = cls
    mask[border] = 255

    img = rng.normal(0.4, 0.08, (size, size, 3)).astype(np.float32)
    # A class-dependent object colour, so the task is learnable.
    color = np.array([0.85, 0.3, 0.25] if cls == 1 else [0.25, 0.35, 0.85], np.float32)
    img[inside] = color + rng.normal(0, 0.05, (int(inside.sum()), 3)).astype(np.float32)
    img = np.clip(img, 0, 1)
    img_norm = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img_norm.astype(np.float32), mask


def synthetic_batch(seed: int, batch_size: int, size: int = 128) -> Dict[str, np.ndarray]:
    """``{"image": (B, S, S, 3) float32 normalized, "mask": (B, S, S) int32}``."""
    rng = np.random.default_rng(seed)
    images, masks = zip(*(synthetic_sample(rng, size) for _ in range(batch_size)))
    return {"image": np.stack(images), "mask": np.stack(masks)}


def as_uint8(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch with its normalized images turned back into uint8 pixels
    (rounded), as a decoding loader delivers them."""
    raw = batch["image"] * IMAGENET_STD + IMAGENET_MEAN
    pixels = np.clip(np.rint(raw * 255.0), 0, 255).astype(np.uint8)
    return {**batch, "image": pixels}
