"""Dataset statistics over an image directory and its masks.

The port's own copy of ``unet_implementations_tpu/utils/dataset_analyzer.py``
(the reference's ``DatasetAnalyzer``): image sizes, aspect ratios, channels
and file sizes, mask value sets and the class counts, with a printable
summary. cv2 and PIL are imported inside ``analyze_dataset``.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class DatasetStats:
    num_images: int = 0
    num_masks: int = 0
    image_sizes: Counter = dataclasses.field(default_factory=Counter)
    aspect_ratios: List[float] = dataclasses.field(default_factory=list)
    channels: Counter = dataclasses.field(default_factory=Counter)
    file_sizes_kb: List[float] = dataclasses.field(default_factory=list)
    mask_values: Counter = dataclasses.field(default_factory=Counter)
    class_counts: Counter = dataclasses.field(default_factory=Counter)
    corrupt: List[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        lines = [
            f"images: {self.num_images} (corrupt: {len(self.corrupt)})",
            f"masks: {self.num_masks}",
            f"channels: {dict(self.channels)}",
            f"top-5 sizes: {self.image_sizes.most_common(5)}",
        ]
        if self.aspect_ratios:
            ar = np.asarray(self.aspect_ratios)
            lines.append(
                f"aspect ratio: min {ar.min():.2f} / median {np.median(ar):.2f} "
                f"/ max {ar.max():.2f}"
            )
        if self.file_sizes_kb:
            fs = np.asarray(self.file_sizes_kb)
            lines.append(f"file size KB: mean {fs.mean():.1f} / max {fs.max():.1f}")
        lines.append(f"mask value histogram: {dict(self.mask_values)}")
        lines.append(f"class counts (1=cat, 2=dog): {dict(self.class_counts)}")
        return "\n".join(lines)


def analyze_dataset(
    images_dir: str | Path,
    masks_dir: Optional[str | Path] = None,
    max_files: Optional[int] = None,
) -> DatasetStats:
    import cv2
    from PIL import Image

    stats = DatasetStats()
    images = sorted(Path(images_dir).glob("*.jpg"))
    if max_files:
        images = images[:max_files]
    for p in images:
        # IMREAD_UNCHANGED, so that grayscale and RGBA files show in the
        # channel counts (IMREAD_COLOR would make every file 3-channel).
        img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        if img is None:
            stats.corrupt.append(p.name)
            continue
        stats.num_images += 1
        h, w = img.shape[:2]
        stats.image_sizes[(h, w)] += 1
        stats.aspect_ratios.append(w / h)
        stats.channels[img.shape[2] if img.ndim == 3 else 1] += 1
        stats.file_sizes_kb.append(p.stat().st_size / 1024)

    if masks_dir is not None:
        for p in sorted(Path(masks_dir).glob("*.png")):
            if max_files and stats.num_masks >= max_files:
                break
            try:
                mask = np.array(Image.open(p))
            except Exception:
                stats.corrupt.append(p.name)
                continue
            if mask.ndim > 2:
                mask = mask[:, :, 0]
            stats.num_masks += 1
            for v in np.unique(mask):
                stats.mask_values[int(v)] += 1
            if 1 in mask:
                stats.class_counts[1] += 1
            elif 2 in mask:
                stats.class_counts[2] += 1
    return stats
