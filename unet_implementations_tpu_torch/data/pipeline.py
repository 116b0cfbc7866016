"""Offline image tools: the padded resize and the CLIP view's copies.

The port's own copy of ``resize_with_padding`` and ``create_clip_resized``
from ``unet_implementations_tpu/data/pipeline.py`` (the rest of that module,
the raw-to-processed pipeline, is not ported yet: ROADMAP.md queue 1 item
9). ``cli clip_resize`` writes each split's ``resized_clip/`` with them, the
directory the loader's CLIP view reads. cv2 is imported inside the
functions, so the module imports on a host without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def resize_with_padding(image: np.ndarray, target_size: int, nearest: bool = False) -> np.ndarray:
    """Aspect-preserving resize, then centred on a black square canvas.

    The longer side maps to ``target_size``; the shorter side scales by the
    same factor with ``int()`` truncation; the padding splits ``//2`` to the
    top and left."""
    import cv2

    height, width = image.shape[:2]
    if height > width:
        new_h, new_w = target_size, int(width * (target_size / height))
    else:
        new_h, new_w = int(height * (target_size / width)), target_size
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    resized = cv2.resize(image, (new_w, new_h), interpolation=interp)
    padded = np.zeros((target_size, target_size, *image.shape[2:]), dtype=image.dtype)
    pad_y = (target_size - new_h) // 2
    pad_x = (target_size - new_w) // 2
    padded[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
    return padded


def create_clip_resized(image_dirs: Sequence[Path], out_dir: Path, target_size: int = 224) -> int:
    """Write a ``target_size``² padded copy (``resize_with_padding``) of
    every ``*.jpg`` in ``image_dirs`` to ``out_dir``, under the same name;
    unreadable files are skipped. Returns the number written."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for d in image_dirs:
        for img_path in sorted(Path(d).glob("*.jpg")):
            img = cv2.imread(str(img_path))
            if img is None:
                continue
            cv2.imwrite(str(out_dir / img_path.name), resize_with_padding(img, target_size))
            n += 1
    return n
