"""Offline preprocessing: raw archive -> the processed directory schema.

The port's own copy of ``unet_implementations_tpu/data/pipeline.py``, host
code with the same index math, call order and file formats, so the same raw
tree and seed give the same split, the same masks bit for bit and the same
jpgs byte for byte:

- corruption filtering (cv2 decode + PIL verify)
- the class of a TrainVal mask from its values (1 cat, 2 dog)
- the seeded stratified train/val split (``random.Random(seed)``, the same
  call order)
- the aspect-preserving resize and centre-pad to 512² (LINEAR for images,
  NEAREST for masks)
- the val/test label remap to {0,1,2,255} at the original size, the class
  from the breed in the file name
- the CLIP view's 224² padded copies (``cli clip_resize``)

Output directory schema (what the loader reads)::

    processed/{Train,Val,Test}/
      color/ label/ resized/            (+ Train/resized_label,
      Val,Test/processed_labels, Train/augmented/{images,masks},
      */resized_clip)

cv2 and PIL are imported inside the functions, so the module imports on a
host without them. ``cli augment`` routes an image whose mask names no class
by its breed (``is_cat_image``).
"""

from __future__ import annotations

import random
import shutil
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

# The cat breeds of the Oxford-IIIT Pet file names (the rest are dogs).
CAT_BREEDS = (
    "abyssinian", "bengal", "birman", "bombay",
    "british", "egyptian", "maine",
    "persian", "ragdoll", "russian", "siamese", "sphynx",
)


def is_cat_image(filename: str) -> bool:
    """Cat or dog from the breed in the file name, case-insensitively."""
    name = filename.lower()
    return any(breed in name for breed in CAT_BREEDS)


def is_image_corrupt(path: Path) -> bool:
    """cv2 decode + PIL verify; either failing marks the file corrupt."""
    import cv2
    from PIL import Image

    try:
        img = cv2.imread(str(path))
        if img is None or img.size == 0:
            return True
        with Image.open(path) as im:
            im.verify()
        return False
    except Exception:
        return True


def get_class_from_mask(mask_path: Path) -> int:
    """1 = cat, 2 = dog, 0 = unknown, from the raw mask's values (1 first)."""
    from PIL import Image

    try:
        mask = np.array(Image.open(mask_path))
        if 1 in mask:
            return 1
        if 2 in mask:
            return 2
        return 0
    except Exception:
        return 0


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


def load_mask(mask_path: Path) -> np.ndarray:
    """A mask read by PIL (cv2 if PIL cannot), first channel of a 3-D one."""
    import cv2
    from PIL import Image

    try:
        with Image.open(mask_path) as im:
            mask = np.array(im)
    except Exception:
        mask = cv2.imread(str(mask_path), cv2.IMREAD_UNCHANGED)
        if mask is None:
            raise ValueError(f"Failed to load mask: {mask_path}")
    if mask.ndim > 2:
        mask = mask[:, :, 0]
    return mask


def remap_raw_mask(mask: np.ndarray, filename: str) -> np.ndarray:
    """A raw val/test mask remapped to {0,1,2,255} at its original size.

    The foreground value, with the reference's escalating fallbacks: 128,
    else the first value outside {0, 255}, else any pixel strictly between 0
    and 255, else the second most common value, else everything that is
    neither background nor border. The class comes from the breed in
    ``filename``; the border 255 is kept. (The third and fourth fallbacks
    cannot fire, as in the reference: kept for line-by-line parity.)
    """
    if mask.ndim > 2:
        mask = mask[:, :, 0]
    cls = 1 if is_cat_image(Path(filename).stem) else 2
    unique_values = np.unique(mask)
    out = np.zeros_like(mask)

    if 128 in unique_values:
        out[mask == 128] = cls
    elif len(unique_values) > 1:
        fg_values = [v for v in unique_values if v not in (0, 255)]
        if fg_values:
            out[mask == fg_values[0]] = cls
        else:
            nonzero = (mask > 0) & (mask < 255)
            if np.any(nonzero):
                out[nonzero] = cls
            else:
                values, counts = np.unique(mask, return_counts=True)
                order = np.argsort(counts)
                if len(order) >= 3:
                    middle = values[order[-2]]
                    if middle not in (0, 255):
                        out[mask == middle] = cls

    out[mask == 255] = 255
    if 1 not in out and 2 not in out:
        out[(mask != 0) & (mask != 255)] = cls
    return out


def stratified_split(
    image_paths: Sequence[Path],
    mask_paths: Sequence[Path],
    val_ratio: float,
    corrupt: Set[str],
    seed: int,
) -> Tuple[List[Tuple[Path, Path]], List[Tuple[Path, Path]]]:
    """Seeded per-class shuffle and split, then a shuffled recombination, with
    the ``random.Random(seed)`` calls in the JAX package's order."""
    rng = random.Random(seed)
    mask_dict = {p.stem: p for p in mask_paths}
    cats, dogs = [], []
    for img in image_paths:
        if img.stem in corrupt:
            continue
        mask = mask_dict.get(img.stem)
        if not mask:
            continue
        cls = get_class_from_mask(mask)
        if cls == 1:
            cats.append((img, mask))
        elif cls == 2:
            dogs.append((img, mask))
    rng.shuffle(cats)
    rng.shuffle(dogs)
    cat_val_n = int(len(cats) * val_ratio)
    dog_val_n = int(len(dogs) * val_ratio)
    train = cats[cat_val_n:] + dogs[dog_val_n:]
    val = cats[:cat_val_n] + dogs[:dog_val_n]
    rng.shuffle(train)
    rng.shuffle(val)
    return train, val


def preprocess_split(
    pairs: Sequence[Tuple[Path, Path]],
    out_dir: Path,
    target_size: int = 512,
    is_train: bool = True,
    copy_originals: bool = True,
) -> Dict[str, int]:
    """One split into the processed schema. Train: padded ``target_size``²
    images (jpg) and NEAREST-resized padded masks (png) in
    ``resized_label``; Val/Test: the padded images and the original-size
    remapped masks in ``processed_labels``."""
    import cv2
    from PIL import Image

    (out_dir / "resized").mkdir(parents=True, exist_ok=True)
    if copy_originals:
        (out_dir / "color").mkdir(exist_ok=True)
        (out_dir / "label").mkdir(exist_ok=True)
    label_dir = out_dir / ("resized_label" if is_train else "processed_labels")
    label_dir.mkdir(exist_ok=True)

    stats = {"images": 0, "masks": 0, "errors": 0}
    for img_path, mask_path in pairs:
        try:
            img = cv2.imread(str(img_path))
            if img is None:
                raise ValueError(f"unreadable image {img_path}")
            resized = resize_with_padding(img, target_size)
            cv2.imwrite(str(out_dir / "resized" / f"{img_path.stem}.jpg"), resized)
            if copy_originals:
                shutil.copy2(img_path, out_dir / "color" / img_path.name)
                shutil.copy2(mask_path, out_dir / "label" / mask_path.name)

            mask = load_mask(mask_path)
            if is_train:
                out_mask = resize_with_padding(mask, target_size, nearest=True)
            else:
                out_mask = remap_raw_mask(mask, mask_path.name)
            Image.fromarray(out_mask.astype(np.uint8)).save(label_dir / f"{mask_path.stem}.png")
            stats["images"] += 1
            stats["masks"] += 1
        except Exception as e:
            print(f"pipeline error for {img_path.name}: {e}")
            stats["errors"] += 1
    return stats


def resolve_raw_layout(raw_dir: str | Path) -> Tuple[Path, Path, Path]:
    """(root, trainval dir, test dir) of a raw archive directory: the
    archive's extraction root (``Dataset_filtered/{TrainVal,Test}``), a
    directory holding ``TrainVal`` (inside the archive), or one holding
    ``Train`` (the simplified layout)."""
    root = Path(raw_dir)
    if (root / "Dataset_filtered").is_dir():
        root = root / "Dataset_filtered"
    trainval = root / "TrainVal"
    if not trainval.is_dir():
        trainval = root / "Train"
    return root, trainval, root / "Test"


def run_pipeline(
    raw_dir: str | Path,
    processed_dir: str | Path,
    val_ratio: float = 0.2,
    seed: int = 42,
    target_size: int = 512,
    verbose: bool = True,
) -> Dict:
    """Raw tree (``resolve_raw_layout``) -> processed directory schema:
    corrupt TrainVal images dropped, the stratified split, each split
    processed. Returns each split's counts."""
    raw_dir, processed_dir = Path(raw_dir), Path(processed_dir)
    raw_dir, trainval_dir, test_dir = resolve_raw_layout(raw_dir)
    train_imgs = sorted((trainval_dir / "color").glob("*.jpg"))
    train_masks = sorted((trainval_dir / "label").glob("*.png"))

    corrupt = {p.stem for p in train_imgs if is_image_corrupt(p)}
    if verbose and corrupt:
        print(f"corrupt files excluded: {sorted(corrupt)}")

    train_pairs, val_pairs = stratified_split(train_imgs, train_masks, val_ratio, corrupt, seed)
    if verbose:
        print(f"split: {len(train_pairs)} train / {len(val_pairs)} val")

    stats = {
        "train": preprocess_split(train_pairs, processed_dir / "Train", target_size,
                                  is_train=True),
        "val": preprocess_split(val_pairs, processed_dir / "Val", target_size, is_train=False),
    }
    test_imgs = sorted((test_dir / "color").glob("*.jpg"))
    test_masks = {p.stem: p for p in sorted((test_dir / "label").glob("*.png"))}
    test_pairs = [(p, test_masks[p.stem]) for p in test_imgs if p.stem in test_masks]
    stats["test"] = preprocess_split(test_pairs, processed_dir / "Test", target_size,
                                     is_train=False)
    return stats
