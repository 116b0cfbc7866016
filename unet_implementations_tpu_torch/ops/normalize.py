"""Device-side pixel normalization — the uint8 input path.

Counterpart of ``unet_implementations_tpu/ops/normalize.py``: raw uint8
pixels cross to the device (4x fewer bytes than float32) and become ImageNet-
normalized float32 there, with the host loader's op order: /255, -mean, /std,
all in float32. The reconstruction path takes ``mode="unit"``: /255 only.
"""

from __future__ import annotations

import numpy as np
import torch

# The ImageNet statistics of the reference's loaders (a copy of
# ``unet_implementations_tpu/data/loader.py``'s constants).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(image: torch.Tensor, mode: str = "imagenet") -> torch.Tensor:
    """uint8 pixels (..., 3) -> normalized float32; float inputs pass through
    unchanged. ``mode``: "imagenet" = /255 then ImageNet mean/std
    (segmentation); "unit" = /255 only (reconstruction)."""
    if mode not in ("imagenet", "unit"):
        raise ValueError(f"unknown normalize mode: {mode!r}")
    if image.dtype != torch.uint8:
        return image
    img = image.to(torch.float32) / 255.0
    if mode == "unit":
        return img
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (img - mean) / std
