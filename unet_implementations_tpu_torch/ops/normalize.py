"""Device-side pixel normalization — the uint8 input path.

Counterpart of ``unet_implementations_tpu/ops/normalize.py``: raw uint8
pixels cross to the device (4x fewer bytes than float32) and become ImageNet-
normalized float32 there, with the host loader's op order: /255, -mean, /std,
all in float32.
"""

from __future__ import annotations

import numpy as np
import torch

# The ImageNet statistics of the reference's loaders (a copy of
# ``unet_implementations_tpu/data/loader.py``'s constants).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 pixels (..., 3) -> ImageNet-normalized float32; float inputs
    pass through unchanged."""
    if image.dtype != torch.uint8:
        return image
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (image.to(torch.float32) / 255.0 - mean) / std
