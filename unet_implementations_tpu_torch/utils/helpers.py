"""Small file and seeding helpers (the port's own copy of
``unet_implementations_tpu/utils/helpers.py``, the reference's
``data_augmentation/utils/helpers.py``)."""

from __future__ import annotations

import os
import random
import shutil
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def seed_everything(seed: int = 42) -> None:
    """Seed Python's and numpy's generators and set PYTHONHASHSEED. The
    port's entry points draw from ``torch.Generator``s they are given, so
    torch's global generator is not seeded here."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def create_directory(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def copy_files(pairs: Iterable[Tuple[Path, Path]]) -> int:
    n = 0
    for src, dst in pairs:
        Path(dst).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst)
        n += 1
    return n


def split_dataset(
    items: Sequence, val_ratio: float, seed: int = 42
) -> Tuple[List, List]:
    """A plain shuffled split (the stratified one is ``data/pipeline.py``'s)."""
    rng = random.Random(seed)
    items = list(items)
    rng.shuffle(items)
    n_val = int(len(items) * val_ratio)
    return items[n_val:], items[:n_val]
