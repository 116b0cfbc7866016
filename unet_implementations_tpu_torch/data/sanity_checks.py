"""Integrity checks of a processed dataset tree.

The port's own copy of ``unet_implementations_tpu/data/sanity_checks.py``:
the file names of each directory pair match (``resized`` and
``resized_label``, augmented images and masks, ``resized`` and
``processed_labels``), the resized images are 512², and the masks hold only
the allowed values (and, in Val and Test, a foreground class). Each check
returns a ``CheckReport``; ``cli sanity_checks`` prints them and exits 1
when one fails. cv2 and PIL are imported inside the functions.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class CheckReport:
    name: str
    passed: bool
    details: List[str] = dataclasses.field(default_factory=list)

    def __str__(self) -> str:
        mark = "OK " if self.passed else "FAIL"
        lines = [f"[{mark}] {self.name}"]
        lines += [f"       {d}" for d in self.details[:20]]
        if len(self.details) > 20:
            lines.append(f"       ... {len(self.details) - 20} more")
        return "\n".join(lines)


def check_pair_consistency(
    dir_a: Path, dir_b: Path, ext_a: str = ".jpg", ext_b: str = ".png",
    name: Optional[str] = None,
) -> CheckReport:
    """Every stem in dir_a must exist in dir_b and vice versa."""
    name = name or f"{dir_a.name} <-> {dir_b.name}"
    a = {p.stem for p in Path(dir_a).glob(f"*{ext_a}")}
    b = {p.stem for p in Path(dir_b).glob(f"*{ext_b}")}
    details = [f"missing in {dir_b.name}: {s}" for s in sorted(a - b)]
    details += [f"missing in {dir_a.name}: {s}" for s in sorted(b - a)]
    return CheckReport(name, not details, details)


def check_resized_dimensions(
    resized_dir: Path, size: int = 512, sample: Optional[int] = None
) -> CheckReport:
    import cv2

    bad = []
    files = sorted(Path(resized_dir).glob("*.jpg"))
    if sample:
        files = files[:sample]
    for p in files:
        img = cv2.imread(str(p))
        if img is None:
            bad.append(f"unreadable: {p.name}")
        elif img.shape[:2] != (size, size):
            bad.append(f"{p.name}: {img.shape[:2]}")
    return CheckReport(f"{resized_dir} all {size}x{size}", not bad, bad)


def check_mask_values(
    masks_dir: Path, allowed=(0, 1, 2, 255), sample: Optional[int] = None,
    require_foreground: bool = False,
) -> CheckReport:
    from PIL import Image

    bad = []
    files = sorted(Path(masks_dir).glob("*.png"))
    if sample:
        files = files[:sample]
    for p in files:
        m = np.array(Image.open(p))
        if m.ndim > 2:
            m = m[:, :, 0]
        vals = set(np.unique(m).tolist())
        if not vals <= set(allowed):
            bad.append(f"{p.name}: values {sorted(vals)}")
        elif require_foreground and not (vals & {1, 2}):
            bad.append(f"{p.name}: no foreground class")
    return CheckReport(f"{masks_dir} values ⊆ {allowed}", not bad, bad)


def run_sanity_checks(processed_dir: str | Path, sample: Optional[int] = None) -> List[CheckReport]:
    """Every check that applies to a processed dataset tree."""
    d = Path(processed_dir)
    reports = []
    train = d / "Train"
    if (train / "resized").exists() and (train / "resized_label").exists():
        reports.append(check_pair_consistency(train / "resized", train / "resized_label"))
        reports.append(check_resized_dimensions(train / "resized", sample=sample))
        reports.append(check_mask_values(train / "resized_label", sample=sample))
    aug_i = train / "augmented" / "images"
    aug_m = train / "augmented" / "masks"
    if aug_i.exists():
        reports.append(check_pair_consistency(aug_i, aug_m, name="augmented images <-> masks"))
        reports.append(check_mask_values(aug_m, sample=sample))
    for split in ("Val", "Test"):
        s = d / split
        if (s / "resized").exists() and (s / "processed_labels").exists():
            reports.append(check_pair_consistency(s / "resized", s / "processed_labels"))
            reports.append(check_mask_values(s / "processed_labels", sample=sample,
                                             require_foreground=True))
    return reports


def debug_mask_values(mask_path: str | Path) -> Dict:
    """A raw mask's encoding: per-channel value histograms, and PIL's load
    against cv2's."""
    import cv2
    from PIL import Image

    out: Dict = {"path": str(mask_path)}
    pil = np.array(Image.open(mask_path))
    out["pil_shape"] = pil.shape
    if pil.ndim == 3:
        out["pil_channel_values"] = {
            c: dict(zip(*[a.tolist() for a in np.unique(pil[:, :, c], return_counts=True)]))
            for c in range(pil.shape[2])
        }
    else:
        vals, counts = np.unique(pil, return_counts=True)
        out["pil_values"] = dict(zip(vals.tolist(), counts.tolist()))
    cv = cv2.imread(str(mask_path), cv2.IMREAD_UNCHANGED)
    out["cv2_shape"] = None if cv is None else cv.shape
    if cv is not None:
        vals, counts = np.unique(cv, return_counts=True)
        out["cv2_values"] = dict(zip(vals.tolist(), counts.tolist()))
    return out
