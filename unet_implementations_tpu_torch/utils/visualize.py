"""Mask colouring for prediction overlays (a copy of the JAX package's
``utils/visualize.py::colorize_mask``)."""

from __future__ import annotations

import numpy as np

CLASS_COLORS = np.array(
    [[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8
)  # background, cat, dog


def colorize_mask(mask: np.ndarray) -> np.ndarray:
    """{0→black, 1→red, 2→green}, 255 black."""
    out = np.zeros((*mask.shape, 3), np.uint8)
    for cls in (1, 2):
        out[mask == cls] = CLASS_COLORS[cls]
    return out
